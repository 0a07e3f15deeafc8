"""Fusion of acmmp_tpu_torch (engine/fusion.py) against acmmp_tpu on the
same views (CPU).

The fixture is `_plane_views` of tests/test_pallas_sample.py (64x48, 4
views of the textured plane, constant depth and normal per view) and a
variant whose depths and normals carry seeded noise that straddles the
depth (1%) and angle (10 degrees) thresholds, with a few holes, so the
accept decision can fail: of the 12,288 pixels of the 4 views, plain
fusion accepts 484 there against 2,820 on the plane (dual: 743 and
2,820). Both packages run plain fusion and the prior-aware dual fusion
(second candidate x1.002, single_match_penalty=1).

Bars: the accept masks agree on at least 99.9% of pixels; where both
accept, points and normals agree within 1e-5 (1 + |p|) and colours are
equal; the greedy consumed masks after each reference view are equal.
Measured: the two agree bitwise on all four cases (accept masks, points,
normals, colours and masks identical), which the test prints and, on
the plane, requires. Fusion has no argmin, but the port's camera products
are multiply-and-sum where the JAX package's are HIGHEST-precision
einsums, so a last-ulp difference could move a pixel across a threshold;
that is what the 99.9% bar allows."""

import os

import numpy as np
import pytest
import torch
from PIL import Image as PILImage

import acmmp_tpu.engine.fusion as jfusion
import jax.numpy as jnp
from acmmp_tpu.config import FusionParams as JaxFusionParams
from acmmp_tpu.core.geometry import angle_between as jax_angle_between
from acmmp_tpu.io.dense_folder import Problem as JaxProblem
from acmmp_tpu_torch.config import FusionParams
from acmmp_tpu_torch.core.geometry import angle_between
from acmmp_tpu_torch.engine import fusion as tfusion
from acmmp_tpu_torch.io import read_ply, write_dmb
from acmmp_tpu_torch.io.dense_folder import Problem, result_dir
from acmmp_tpu_torch.pipeline.scheduler import generate_sample_list
from acmmp_tpu_torch.utils.synth import (textured_plane_scene,
                                         write_dense_folder)

torch.set_num_threads(1)

N_VIEWS, W, H = 4, 64, 48
ACCEPT_SHARE = 0.999
POINT_RTOL = 1e-5


def test_angle_between_matches_jnp():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(200, 3)).astype(np.float32)
    b = rng.normal(size=(200, 3)).astype(np.float32)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    b[:3] = a[:3]                       # dot at the clip edge
    b[3] = -a[3]
    a[4] = np.nan                       # NaN-safe: 0
    got = angle_between(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    want = np.asarray(jax_angle_between(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got[4] == 0.0


def _arrays(noisy: bool, second: bool):
    """Per view (rgb image, camera, depth, normal, second-candidate
    kwargs), as numpy, for both packages."""
    images, cams, plane_z = textured_plane_scene(n_views=N_VIEWS, width=W,
                                                 height=H)
    rng = np.random.default_rng(11)
    out = []
    for i in range(N_VIEWS):
        depth = np.full((H, W), plane_z, np.float32)
        normal = np.zeros((H, W, 3), np.float32)
        normal[..., 2] = -1.0
        if noisy:
            depth = depth * (1.0 + 0.003 * rng.normal(size=(H, W)))
            depth[rng.random((H, W)) < 0.02] = 0.0
            normal = normal + 0.06 * rng.normal(size=(H, W, 3))
            normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
        depth, normal = depth.astype(np.float32), normal.astype(np.float32)
        kw = {}
        if second:
            d1 = depth * 1.002
            if noisy:
                d1 = d1 * (1.0 + 0.0015 * rng.normal(size=(H, W)))
            kw = dict(depth1=d1.astype(np.float32), normal1=normal.copy())
        img = np.stack([images[i]] * 3, axis=-1).astype(np.float32)
        out.append((img, cams[i], depth, normal, kw))
    return out


def _fuse(port: bool, arrays, prior_aware: bool, debug_dir):
    """(points, normals, colours, accept masks, consumed masks after each
    reference view) of one package's fuse_views."""
    pkg = tfusion if port else jfusion
    prob_cls = Problem if port else JaxProblem
    fp_cls = FusionParams if port else JaxFusionParams
    views = {i: pkg.FusionView(img, cam, d, n, **kw)
             for i, (img, cam, d, n, kw) in enumerate(arrays)}
    problems = [prob_cls(ref_image_id=i,
                         src_image_ids=[j for j in range(N_VIEWS) if j != i])
                for i in range(N_VIEWS)]
    masks = []

    def progress(i, n):
        masks.append(np.stack([views[s].mask.copy() for s in range(N_VIEWS)]))

    kw = dict(device="cpu") if port else {}
    pts, nrm, col = pkg.fuse_views(
        views, problems, fp_cls(num_consistent_thresh=2),
        prior_aware=prior_aware,
        single_match_penalty=1 if prior_aware else 0, progress=progress,
        debug_dir=debug_dir, **kw)
    accept = np.stack([
        np.asarray(PILImage.open(os.path.join(
            debug_dir, f"approved_pixels_cam_{i}.png"))) > 127
        for i in range(N_VIEWS)])
    return pts, nrm, col, accept, np.stack(masks)


def _per_pixel(vals, accept):
    """Scatter the concatenated per-view rows back onto [V, H, W, 3]."""
    out = np.full(accept.shape + (3,), np.nan, np.float32)
    out[accept] = vals
    return out


@pytest.mark.parametrize("noisy", [False, True], ids=["plane", "noisy"])
@pytest.mark.parametrize("prior_aware", [False, True], ids=["plain", "dual"])
def test_fuse_views_agrees_with_jax(tmp_path, noisy, prior_aware):
    arrays = _arrays(noisy, second=prior_aware)
    t = _fuse(True, arrays, prior_aware, str(tmp_path / "port"))
    j = _fuse(False, arrays, prior_aware, str(tmp_path / "jax"))
    (tp, tn, tc, ta, tm), (jp, jn, jc, ja, jm) = t, j
    assert ja.sum() > 100, ja.sum()
    agree = (ta == ja).mean()
    assert agree >= ACCEPT_SHARE, agree
    both = ta & ja
    for a, b in ((tp, jp), (tn, jn)):
        a, b = _per_pixel(a, ta)[both], _per_pixel(b, ja)[both]
        assert (np.abs(a - b) <= POINT_RTOL * (1.0 + np.abs(b))).all()
    np.testing.assert_array_equal(_per_pixel(tc, ta)[both],
                                  _per_pixel(jc, ja)[both])
    assert tm.shape == jm.shape == (N_VIEWS, N_VIEWS, H, W)
    np.testing.assert_array_equal(tm, jm)
    bitwise = all(np.array_equal(np.asarray(a), np.asarray(b))
                  for a, b in ((tp, jp), (tn, jn), (tc, jc), (ta, ja)))
    print(f"accept agreement {agree:.6f}, bitwise {bitwise}")
    if not noisy:
        # the plane views sit far from every threshold
        assert bitwise


def _loaded_views(arrays, loads):
    def load_one(i):
        loads.append(i)
        img, cam, d, n, kw = arrays[i]
        return tfusion.FusionView(img, cam, d, n, **kw)
    return load_one


def test_lazy_fusion_load_count_bounded_and_equal():
    """With a cache smaller than a problem's view set, fusion loads each
    view at most once per problem and gives the eager result
    (tests/test_pipeline.py::test_lazy_fusion_load_count_bounded)."""
    arrays = _arrays(noisy=True, second=False)
    problems = [Problem(ref_image_id=i,
                        src_image_ids=[j for j in range(N_VIEWS) if j != i])
                for i in range(N_VIEWS)]
    fp = FusionParams(num_consistent_thresh=2)
    loads = []
    lazy = tfusion.LazyFusionViews(range(N_VIEWS),
                                   _loaded_views(arrays, loads), max_cached=2)
    got = tfusion.fuse_views(lazy, problems, fp, device="cpu")
    eager = {i: _loaded_views(arrays, [])(i) for i in range(N_VIEWS)}
    want = tfusion.fuse_views(eager, problems, fp, device="cpu")
    assert len(want[0]) > 0
    assert len(loads) <= N_VIEWS * N_VIEWS, loads
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A dense folder with two checkpoint folders: ACMMP_fusion (the
    plane) and ACMMP (candidate 1, consistent only on the left half)."""
    images, cams, plane_z = textured_plane_scene(n_views=N_VIEWS, width=W,
                                                 height=H)
    dense = write_dense_folder(str(tmp_path_factory.mktemp("ckpt") / "s"),
                               images, cams)
    for i in range(N_VIEWS):
        depth = np.full((H, W), plane_z, np.float32)
        normal = np.zeros((H, W, 3), np.float32)
        normal[..., 2] = -1.0
        depth1 = depth.copy()
        depth1[:, W // 2:] += 3.0
        for folder, d in (("ACMMP_fusion", depth), ("ACMMP", depth1)):
            rdir = result_dir(os.path.join(dense, folder), i)
            os.makedirs(rdir, exist_ok=True)
            write_dmb(os.path.join(rdir, "depths.dmb"), d)
            write_dmb(os.path.join(rdir, "normals.dmb"), normal)
    return dense


@pytest.mark.parametrize("prior_aware", [False, True], ids=["plain", "dual"])
def test_lazy_fusion_from_disk_matches_eager(checkpoints, prior_aware):
    """A 2-view LRU cache (arrays evicted and reloaded mid-run) gives the
    load-everything cloud (tests/test_pipeline.py::
    test_lazy_fusion_view_cache_matches_eager and
    test_lazy_prior_aware_fusion_matches_eager)."""
    dense = checkpoints
    out = os.path.join(dense, "ACMMP")
    problems = generate_sample_list(dense)
    fp = FusionParams(num_consistent_thresh=2)
    clouds = []
    for name, cache in (("eager", 0), ("lazy", 2)):
        if prior_aware:
            ply = tfusion.run_prior_aware_fusion(
                dense, out, os.path.join(dense, "ACMMP_fusion"), problems,
                geom_consistency=False, fp=fp, single_match_penalty=1,
                ply_name=f"{name}_dual.ply", view_cache=cache, device="cpu")
        else:
            ply = tfusion.run_fusion(
                dense, os.path.join(dense, "ACMMP_fusion"), problems,
                geom_consistency=False, fp=fp, ply_name=f"{name}.ply",
                view_cache=cache, device="cpu")
        clouds.append(read_ply(ply))
    assert len(clouds[0][0]) > 0
    for a, b in zip(*clouds):
        np.testing.assert_array_equal(a, b)
