"""acmmp_tpu_torch's solver modes against acmmp_tpu on the same inputs
(CPU), and the asserts of the JAX package's mode tests on the port's own
solves. No JAX whole solve runs here: the JAX side is its restricted
score and its eager init_state (its eager sweep_once is in
tests/test_torch_sweeps.py).

init_state, per mode, on one problem carried across with
solver_inputs_from_numpy and the same key: the planes within 1e-5 (the
planar-prior branch draws through the bitwise pixel RNG and perturbs
with sin/cos, a few ulp apart), the geometric costs at the geom bar
(1e-4), and the ZNCC costs at the ZNCC bar of ROADMAP.md's rules (fewer
than 0.1% beyond 2e-3 + 1e-3 |ref|): the port's moments are centred, the
JAX package's are not, so the init costs are only ZNCC-close."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmmp_tpu.config import PatchMatchParams as JaxParams
from acmmp_tpu.engine import patchmatch as jpm
from acmmp_tpu.engine.inputs import build_solver_inputs as jax_inputs
from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.engine import patchmatch as tpm
from acmmp_tpu_torch.engine.inputs import (build_solver_inputs,
                                           solver_inputs_from_numpy)
from acmmp_tpu_torch.engine.priors import build_planar_prior
from acmmp_tpu_torch.ops import geom as tgeom
from acmmp_tpu_torch.ops import keys
from acmmp_tpu_torch.ops import ncc as tncc
from acmmp_tpu_torch.utils.synth import textured_plane_scene

from .util import textured_plane_scene as jax_scene

torch.set_num_threads(1)

TP = PatchMatchParams(patch_size=7)
JP = JaxParams(patch_size=7, ncc_backend="jnp")
INTERIOR = np.s_[6:42, 8:56]


def _zncc_bar(got, want):
    got, want = np.asarray(got), np.asarray(want)
    bad = np.abs(got - want) > 2e-3 + 1e-3 * np.abs(want)
    assert bad.mean() < 1e-3, (bad.mean(), np.abs(got - want).max())


def _true_planes(cam, h, w, plane_z):
    """The true plane at every pixel, in numpy: camera-frame normal
    R (0, 0, -1) and offset w = -n . X of the pixel's point at plane_z."""
    x, y = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32))
    n = (cam.R @ np.array([0.0, 0.0, -1.0], np.float32)).astype(np.float32)
    X = np.stack([plane_z * (x - cam.K[0, 2]) / cam.K[0, 0],
                  plane_z * (y - cam.K[1, 2]) / cam.K[1, 1],
                  np.full_like(x, plane_z)], axis=-1)
    wv = -(X * n).sum(-1)
    return np.concatenate([np.broadcast_to(n, (h, w, 3)), wv[..., None]],
                          axis=-1).astype(np.float32)


@pytest.fixture(scope="module")
def problem():
    """View 0 of the 64x48, 4-view scene solved photometrically by the
    port, and every mode's inputs built from that solve."""
    images, cams, plane_z = textured_plane_scene(n_views=4, width=64,
                                                 height=48)
    h, w = images[0].shape
    inputs = build_solver_inputs(images[0], images[1:], cams[0], cams[1:],
                                 TP, pad_h=1, pad_w=1, device="cpu")
    out = tpm.run_patchmatch(inputs, keys.key(0), TP)
    depth, cost = out.depth.numpy(), out.cost.numpy()
    dmin = float(cams[0].depth_min * TP.depth_min_relax)
    dmax = float(cams[0].depth_max * TP.depth_max_relax)
    prior_planes, prior_mask = build_planar_prior(cams[0], depth, cost, dmin,
                                                  dmax, w, h)
    assert prior_planes is not None
    kw = dict(src_depths=[depth * (1.0 + 0.002 * j) for j in range(1, 4)],
              init_depth=depth, init_normal_world=out.normal_world.numpy(),
              init_cost=cost, prior_planes=prior_planes,
              prior_mask=prior_mask,
              seed_planes=_true_planes(cams[0], h, w, plane_z),
              pre_costs=cost + 0.3)
    return dict(images=images, cams=cams, plane_z=plane_z, out=out, kw=kw)


def test_restricted_score_matches_jax():
    rng = np.random.default_rng(0)
    shape = (5, 12, 16)
    cost = rng.uniform(0, 2, shape).astype(np.float32)
    depth = rng.uniform(2, 10, shape).astype(np.float32)
    normal = rng.normal(size=shape + (3,)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    prior = rng.normal(size=shape[1:] + (4,)).astype(np.float32)
    prior[..., :3] /= np.linalg.norm(prior[..., :3], axis=-1, keepdims=True)
    prior_depth = rng.uniform(2, 10, shape[1:]).astype(np.float32)
    got = tpm._restricted_score(
        torch.as_tensor(cost), torch.as_tensor(depth),
        torch.as_tensor(normal), torch.as_tensor(prior)[None],
        torch.as_tensor(prior_depth)[None], torch.tensor(1.6),
        torch.tensor(11.0), TP)
    want = jpm._restricted_score(cost, depth, normal, prior[None],
                                 prior_depth[None], jnp.float32(1.6),
                                 jnp.float32(11.0), JP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("flags", ["seeded", "planar_prior",
                                   "geom_consistency", "hierarchy"])
def test_init_state_matches_jax(problem, flags):
    p = problem
    images, cams, _ = jax_scene(n_views=4, width=64, height=48)
    jin = jax_inputs(images[0], images[1:], cams[0], cams[1:], JP, pad_h=1,
                     pad_w=1, **p["kw"])
    key = jax.random.key(5)
    tin, tkey = solver_inputs_from_numpy(jax.tree.map(np.asarray, jin),
                                         jax.random.key_data(key),
                                         device="cpu")
    want = jpm.init_state(jin, key, JP, jpm.Mode(**{flags: True}))
    got = tpm.one_view(tpm.init_state, tin, tkey, TP,
                       tpm.Mode(**{flags: True}))
    np.testing.assert_allclose(got.planes.numpy(), np.asarray(want.planes),
                               rtol=1e-5, atol=1e-5)
    _zncc_bar(got.ncc_pv, want.ncc_pv)
    _zncc_bar(got.costs, want.costs)
    np.testing.assert_array_equal(got.pre_costs.numpy(),
                                  np.asarray(want.pre_costs))
    if flags == "geom_consistency":
        assert got.geom_pv.shape == got.ncc_pv.shape
        np.testing.assert_allclose(got.geom_pv.numpy(),
                                   np.asarray(want.geom_pv), rtol=1e-4,
                                   atol=1e-4)
    else:
        assert got.geom_pv is None and want.geom_pv is None


def test_seeded_solve_recovers_plane(problem):
    """The asserts of tests/test_modes.py::test_seeded_solve_from_written_
    priors on the port's solves, with the seed planes built in numpy: a
    solve seeded at the true plane recovers it, at least as well as random
    init, on one iteration."""
    p = problem
    images, cams, plane_z = p["images"], p["cams"], p["plane_z"]
    params = PatchMatchParams(patch_size=7, max_iterations=1)
    inputs = build_solver_inputs(images[0], images[1:], cams[0], cams[1:],
                                 params, pad_h=1, pad_w=1, device="cpu",
                                 seed_planes=p["kw"]["seed_planes"])
    out = tpm.run_patchmatch(inputs, keys.key(0), params,
                             tpm.Mode(seeded=True))
    err = np.abs(out.depth.numpy()[INTERIOR] - plane_z)
    assert np.median(err) < 0.05, np.median(err)
    out_r = tpm.run_patchmatch(inputs, keys.key(0), params, tpm.Mode())
    err_r = np.abs(out_r.depth.numpy()[INTERIOR] - plane_z)
    assert np.median(err) <= np.median(err_r) + 1e-6


def _carried_state(problem, mode, pre_costs, views=4):
    p = problem
    images, cams = p["images"], p["cams"]
    kw = dict(p["kw"], pre_costs=pre_costs)
    kw["src_depths"] = kw["src_depths"][:views - 1]
    inputs = build_solver_inputs(images[0], images[1:views], cams[0],
                                 cams[1:views], TP, pad_h=1, pad_w=1,
                                 device="cpu", **kw)
    key = keys.key(11)
    state = tpm.one_view(tpm.init_state, inputs, key, TP, mode)
    for s in range(4):
        state = tpm.one_view(tpm.sweep_once, state, inputs, s,
                             keys.fold_in(key, s), TP, mode)
    vg = tncc.make_view_geometry(inputs.ref_cam, inputs.src_cams)
    ncc = tncc.multiview_zncc(inputs.ref_img, inputs.src_imgs, vg,
                              state.planes[None], TP,
                              n_views=int(inputs.view_mask.sum()))[0]
    np.testing.assert_allclose(state.ncc_pv.numpy(), ncc.numpy(), rtol=1e-4,
                               atol=1e-4)
    return inputs, state


def test_carried_pv_consistent_hierarchy_planar(problem):
    """tests/test_patchmatch.py::test_carried_pv_consistent_hierarchy_planar
    on the port: after 4 hierarchy + planar-prior half-sweeps the carried
    per-view ZNCC equals a re-scoring of the stored planes, including where
    the hierarchy gate rejected an adopted candidate (left half: slack
    pre-costs, right half: converged ones that shut the gate)."""
    cost = problem["kw"]["init_cost"]
    pre = cost.copy()
    pre[:, : cost.shape[1] // 2] += 1.0
    _carried_state(problem, tpm.Mode(hierarchy=True, planar_prior=True), pre,
                   views=3)


def test_carried_geom_pv_consistent(problem):
    """The same for the carried geometric costs of a geometric solve."""
    inputs, state = _carried_state(problem,
                                   tpm.Mode(geom_consistency=True), None)
    geom = tgeom.geom_consistency_cost(inputs.ref_cam, inputs.src_cams,
                                       inputs.src_depths, state.planes, TP)
    assert (geom < TP.geom_cost_max).float().mean() > 0.5
    np.testing.assert_allclose(state.geom_pv.numpy(), geom.numpy(),
                               rtol=1e-4, atol=1e-4)

