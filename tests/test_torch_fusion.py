"""Fusion of acmmp_tpu_torch (engine/fusion.py) against acmmp_tpu on the
same views (CPU).

Three scenes of 4 views at 64x48: `plane`, the `_plane_views` fixture of
tests/test_pallas_sample.py (the textured plane, constant depth and
normal per view); `noisy`, the plane with seeded noise that straddles the
depth (1%) and angle (10 degrees) thresholds and a few holes; `relief`,
the relief surface of the DTU method grid's scan on a convergent rig
(textured_relief_scene), each view's depth and normal cast from the
surface, with seeded noise. Both packages run plain fusion and the
prior-aware dual fusion (second candidate x1.002, single_match_penalty=1).

Bars: the accept masks, the greedy consumed masks after each reference
view, the normals and the colours are equal; the points are equal on the
plane scenes and within one float32 ulp of the point's largest coordinate
on the relief. The port's fusion rounds its camera math, exp and acos as
the JAX package's compiled program does on an x86-64 host with FMA
(core/fused_math.py). With AVX-512 XLA:CPU leaves two of the three
components of its cam_to_world product unfused, a vector-width artifact;
so the relief points are also held bitwise to the JAX package compiled
for AVX2 (--xla_cpu_max_isa=AVX2, in a child process,
tests/_torch_fusion_isa_child.py). A fusion that rounds each product
apart, as eager torch does, takes one accept decision on the relief
otherwise (plain) and misses the AVX2 compile's points in 916 of 5,973
coordinates (dual)."""

import os
import subprocess
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch
from PIL import Image as PILImage

import acmmp_tpu.engine.fusion as jfusion
import jax
import jax.numpy as jnp
from acmmp_tpu.config import FusionParams as JaxFusionParams
from acmmp_tpu.core.geometry import angle_between as jax_angle_between
from acmmp_tpu.io.dense_folder import Problem as JaxProblem
from acmmp_tpu_torch.config import FusionParams
from acmmp_tpu_torch.core import fused_math as fm
from acmmp_tpu_torch.engine import fusion as tfusion
from acmmp_tpu_torch.io import read_ply, write_dmb
from acmmp_tpu_torch.io.dense_folder import Problem, result_dir
from acmmp_tpu_torch.pipeline.scheduler import generate_sample_list
from acmmp_tpu_torch.utils.synth import (textured_plane_scene,
                                         textured_relief_scene,
                                         write_dense_folder)

torch.set_num_threads(1)

N_VIEWS, W, H = 4, 64, 48
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_angle_between_matches_jnp():
    """Fusion's angle is the JAX package's compiled angle_between, bit for
    bit: the dot as an FMA chain, XLA's acos on glibc's atan2f. 4,000
    near-aligned pairs (angles under about 0.4 rad, fusion's working
    range) and 4,000 independent pairs, whose angles span [0, pi] and so
    every range of atanf's argument reduction and both signs of the dot
    (checked below)."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(8000, 3)).astype(np.float32)
    b = rng.normal(size=(8000, 3)).astype(np.float32)
    b[:4000] = a[:4000] + 0.1 * b[:4000]
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    b[:3] = a[:3]                       # dot at the clip edge
    b[3] = -a[3]
    a[4] = np.nan                       # NaN-safe: 0
    got = tfusion._angle(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    want = np.asarray(jax.jit(jax_angle_between)(jnp.asarray(a),
                                                 jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    assert got[4] == 0.0
    # acos(d) = atan2(sqrt(1 - d^2), d): atanf reduces tan = sqrt(1 -
    # d^2) / |d| by the ranges split at 7/16, 11/16, 19/16 and 39/16
    d = (a[5:].astype(np.float64) * b[5:]).sum(-1)
    tan = np.sqrt(1.0 - d * d) / np.abs(d)
    ranges = np.searchsorted([7 / 16, 11 / 16, 19 / 16, 39 / 16], tan)
    for neg in (False, True):
        assert len(set(ranges[(d < 0) == neg])) == 5


def _nearest_f32(x: Fraction) -> np.float32:
    """The float32 nearest to the rational x, ties to even."""
    r = np.float32(float(x))
    cands = (np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(np.float32(v).view(np.int32)) & 1))


def _around(values, n):
    """Each float32 value with the n float32 values on either side."""
    out = []
    for v in np.float32(values):
        lo = hi = v
        out.append(v)
        for _ in range(n):
            lo = np.nextafter(lo, np.float32(-np.inf))
            hi = np.nextafter(hi, np.float32(np.inf))
            out += [lo, hi]
    return np.array(out, np.float32)


@pytest.mark.parametrize("fn", ["fma", "exp", "sqrt", "acos", "atan2"])
def test_fused_math(fn):
    """core/fused_math.py: fma rounds the exact a*b + c once (held to
    rational arithmetic, cancellations and sums that a float64 sum rounds
    onto a float32 midpoint included; infinite and NaN terms as IEEE fma
    gives them); exp, acos and atan2 are XLA:CPU's, bit for bit (acos on
    the dots where atanf's ranges meet, atan2 on every branch of glibc's
    atan2f that a y >= 0 reaches); sqrt is the correctly rounded root
    (torch's CPU float32 sqrt is not, on the share of values printed)."""
    rng = np.random.default_rng(1)
    if fn == "sqrt":
        x = np.abs(rng.normal(size=200000) * 100.0).astype(np.float32)
        got = fm.sqrt(torch.as_tensor(x)).numpy()
        want = np.sqrt(x.astype(np.float64)).astype(np.float32)
        eager = torch.sqrt(torch.as_tensor(x)).numpy()
        print(f"torch.sqrt off the correctly rounded root on "
              f"{float((eager != want).mean()):.4f} of the values")
    elif fn == "fma":
        a, b, c = (rng.normal(size=2000).astype(np.float32) * s
                   for s in (3.0, 1e-3, 7.0))
        c[:500] = -(a[:500] * b[:500]).astype(np.float32)
        # a*b = 2^-24 - 2^-60 on c = 1 + k 2^-23 (k odd): the float64 sum
        # is the float32 midpoint c + 2^-24, the exact sum below it
        for i, (k, sign) in enumerate(((1, 1), (3, 1), (1, -1), (5, -1))):
            a[i] = sign * 2.0 ** -12 * (1 + 2.0 ** -18)
            b[i] = 2.0 ** -12 * (1 - 2.0 ** -18)
            c[i] = sign * (1 + k * 2.0 ** -23)
        got = fm.fma(torch.as_tensor(a), torch.as_tensor(b),
                     torch.as_tensor(c)).numpy()
        want = np.array([_nearest_f32(Fraction(float(x)) * Fraction(float(y))
                                      + Fraction(float(z)))
                         for x, y, z in zip(a, b, c)], np.float32)
        inf, nan = np.inf, np.nan
        special = np.float32([[inf, 2, 1], [1, inf, -1], [-inf, 1, 5],
                              [2, -inf, 3], [inf, 0, 1], [0, inf, 1],
                              [inf, 1, -inf], [1, 1, inf], [3e38, 10, 1],
                              [-3e38, 10, 1], [nan, 1, 1], [1, 1, nan]])
        np.testing.assert_array_equal(
            fm.fma(*torch.as_tensor(special).T).numpy(),
            np.float32([inf, inf, -inf, -inf, nan, nan, nan, inf, inf,
                        -inf, nan, nan]))
    elif fn == "exp":
        x = -rng.uniform(0.0, 20.0, 200000).astype(np.float32)
        got = fm.exp(torch.as_tensor(x)).numpy()
        want = np.asarray(jax.jit(jnp.exp)(x))
    elif fn == "acos":
        # the dots whose tan meets a range boundary (7/16, 11/16, 19/16,
        # 39/16, 2^25), either sign, 300 ulps around each
        edges = 1.0 / np.sqrt(1.0 + np.array(
            [7 / 16, 11 / 16, 19 / 16, 39 / 16, 2.0 ** 25]) ** 2)
        x = np.concatenate([
            rng.uniform(-1.0, 1.0, 100000).astype(np.float32),
            _around(np.concatenate([edges, -edges]), 300),
            _around([-1.0, 0.0, 1.0], 300), np.float32([-0.0, 1e-30])])
        x = x[np.abs(x) <= 1.0]
        got = fm.acos(torch.as_tensor(x)).numpy()
        want = np.asarray(jax.jit(jnp.arccos)(x))
    else:
        n = 100000
        y = np.abs(rng.normal(size=n) * np.exp(rng.uniform(-40, 40, n)))
        x = rng.normal(size=n) * np.exp(rng.uniform(-40, 40, n))
        y, x = y.astype(np.float32), x.astype(np.float32)
        y[:100] = 0.0                   # and y/x beyond 2^60 either way
        x[100:200] = 0.0
        x[200:300] = 1.0
        x[300:400] = -1.0
        y[400:500] = np.nan
        got = fm._atan2_nonneg_y(torch.as_tensor(y),
                                 torch.as_tensor(x)).numpy()
        want = np.asarray(jax.jit(jnp.arctan2)(y, x))
        ratio = np.log2(y[500:]) - np.log2(np.abs(x[500:]))
        assert (ratio > 61).any() and (ratio < -61).any()
    np.testing.assert_array_equal(got, want)


def _relief_views(noise=0.002, seed=37, amp=0.35, base_z=5.0):
    """(images, cameras, depths, camera-frame normals) of the relief
    surface z = base_z + amp (sin 1.1x cos 0.9y + 0.5 sin(2.3x + 1)),
    depths and normals cast from it per view (Newton along each ray, as
    textured_relief_scene renders), with seeded multiplicative depth
    noise and normal noise."""
    images, cams, _ = textured_relief_scene(
        n_views=N_VIEWS, width=W, height=H, f=140.0 * W / 96.0, spread=0.4,
        converge=True)
    rng = np.random.default_rng(seed)

    def z_surf(x, y):
        return base_z + amp * (np.sin(1.1 * x) * np.cos(0.9 * y)
                               + 0.5 * np.sin(2.3 * x + 1.0))

    depths, normals = [], []
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64))
    for cam in cams:
        d = np.stack([(xs - cam.K[0, 2]) / cam.K[0, 0],
                      (ys - cam.K[1, 2]) / cam.K[1, 1],
                      np.ones_like(xs)], -1) @ cam.R
        c = -cam.R.T @ cam.t
        s = (base_z - c[2]) / d[..., 2]
        for _ in range(30):
            p = c + s[..., None] * d
            s = s - 0.8 * (p[..., 2] - z_surf(p[..., 0], p[..., 1])) / d[
                ..., 2]
        p = c + s[..., None] * d
        x, y = p[..., 0], p[..., 1]
        gx = amp * (1.1 * np.cos(1.1 * x) * np.cos(0.9 * y)
                    + 1.15 * np.cos(2.3 * x + 1.0))
        gy = -amp * 0.9 * np.sin(1.1 * x) * np.sin(0.9 * y)
        n = np.stack([-gx, -gy, np.ones_like(gx)], -1)
        n = (n / np.linalg.norm(n, axis=-1, keepdims=True)) @ cam.R.T
        n = np.where((n[..., 2] > 0)[..., None], -n, n)
        depth = ((p - c) @ cam.R.T)[..., 2]
        depth = depth * (1.0 + noise * rng.normal(size=depth.shape))
        n = n + 3 * noise * rng.normal(size=n.shape)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        depths.append(depth.astype(np.float32))
        normals.append(n.astype(np.float32))
    return images, cams, depths, normals


def _arrays(scene: str, second: bool):
    """Per view (rgb image, camera, depth, normal, second-candidate
    kwargs), as numpy, for both packages."""
    if scene == "relief":
        images, cams, depths, normals = _relief_views()
    else:
        images, cams, plane_z = textured_plane_scene(n_views=N_VIEWS,
                                                     width=W, height=H)
        depths = [np.full((H, W), plane_z, np.float32)] * N_VIEWS
        normals = [np.tile(np.float32([0, 0, -1]), (H, W, 1))] * N_VIEWS
    noisy = scene == "noisy"
    rng = np.random.default_rng(11)
    out = []
    for i in range(N_VIEWS):
        depth, normal = depths[i], normals[i]
        if noisy:
            depth = depth * (1.0 + 0.003 * rng.normal(size=(H, W)))
            depth[rng.random((H, W)) < 0.02] = 0.0
            normal = normal + 0.06 * rng.normal(size=(H, W, 3))
            normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
        depth, normal = depth.astype(np.float32), normal.astype(np.float32)
        kw = {}
        if second:
            d1 = depth * 1.002
            if scene != "plane":
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


def _ulps_of_max(a, b):
    """|a - b| in float32 ulps of each point's largest coordinate."""
    scale = np.spacing(np.abs(b).max(-1, keepdims=True))
    return np.abs(a.astype(np.float64) - b) / scale


@pytest.fixture(scope="module")
def relief_avx2(tmp_path_factory):
    """The JAX package's plain and dual fusion of the relief views,
    compiled for AVX2 in a child process: {variant_field: array}."""
    work = tmp_path_factory.mktemp("isa")
    arrays = _arrays("relief", second=True)
    cams = [a[1] for a in arrays]
    fields = dict(
        image=[a[0] for a in arrays], depth=[a[2] for a in arrays],
        normal=[a[3] for a in arrays],
        depth1=[a[4]["depth1"] for a in arrays],
        normal1=[a[4]["normal1"] for a in arrays],
        K=[c.K for c in cams], R=[c.R for c in cams], t=[c.t for c in cams],
        depth_min=[c.depth_min for c in cams],
        depth_max=[c.depth_max for c in cams],
        width=[c.width for c in cams], height=[c.height for c in cams])
    np.savez(work / "views.npz", **{k: np.stack(v) for k, v in fields.items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX2")
    subprocess.run([sys.executable,
                    os.path.join(REPO, "tests", "_torch_fusion_isa_child.py"),
                    str(work / "views.npz"), str(work / "out.npz")],
                   env=env, check=True, timeout=300)
    return dict(np.load(work / "out.npz"))


@pytest.mark.parametrize("scene", ["plane", "noisy", "relief"])
@pytest.mark.parametrize("prior_aware", [False, True], ids=["plain", "dual"])
def test_fuse_views_agrees_with_jax(tmp_path, scene, prior_aware, request):
    arrays = _arrays(scene, second=prior_aware)
    t = _fuse(True, arrays, prior_aware, str(tmp_path / "port"))
    j = _fuse(False, arrays, prior_aware, str(tmp_path / "jax"))
    (tp, tn, tc, ta, tm), (jp, jn, jc, ja, jm) = t, j
    assert ja.sum() > 100, ja.sum()
    np.testing.assert_array_equal(ta, ja)
    assert tm.shape == jm.shape == (N_VIEWS, N_VIEWS, H, W)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tc, jc)
    if scene != "relief":
        np.testing.assert_array_equal(tp, jp)
        return
    ulps = _ulps_of_max(tp, jp)
    print(f"relief {'dual' if prior_aware else 'plain'}: "
          f"{int(ta.sum())} accepted, points bitwise "
          f"{float((tp == jp).all(1).mean()):.4f}, max {ulps.max():.3f} ulp")
    assert ulps.max() <= 1.0, ulps.max()
    # bitwise to the JAX package compiled without AVX-512
    avx2 = request.getfixturevalue("relief_avx2")
    tag = "dual" if prior_aware else "plain"
    for got, name in ((tp, "pts"), (tn, "nrm"), (tc, "col")):
        np.testing.assert_array_equal(got, avx2[f"{tag}_{name}"])


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
    arrays = _arrays("noisy", second=False)
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
