"""acmmp_tpu_torch's propagation, view selection, median and the whole
photometric solve against acmmp_tpu on the same inputs (CPU).

Propagation candidates, the view prior and the median are gathers, sorts
and comparisons: bitwise. View selection exponentiates costs; XLA:CPU's
exp and fused multiply-adds differ from PyTorch's by an ulp, which can
move a CDF entry across one of the 15 samples, so its weights are held to
agree at all but 0.2% of pixels (measured here: all of them), and bitwise
where they agree.

The whole solve (64x48, 4 views, patch_size=7, the setup of
tests/test_patchmatch.py) is compared by the share of interior pixels
whose depths agree within a relative tolerance. Argmin near-ties flip
winners: the f32 ZNCC differs by ~1e-4 between the two packages, and the
solve amplifies that. The test measures that amplification too: the
port's solve against itself with 1e-5 Gaussian noise added to every ZNCC
cost. Measured (this test, CPU): port vs JAX 85.3% of interior depths
within 1% and 98.8% within 5%; port vs noisy port 84.0% and 97.8%. The
cross-package gap is the solve's sensitivity to f32 rounding, not a
fault; the test pins both shares below the measured values and holds the
cross-package share to the self-noise share. At 64x48 effective_params
already switches the windowed depth law off, so the window branch is
exercised by the random_depth unit tests (test_torch_geometry_rng.py).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from acmmp_tpu.config import PatchMatchParams as JaxParams
from acmmp_tpu.engine.inputs import build_solver_inputs
from acmmp_tpu.engine.patchmatch import Mode as JaxMode
from acmmp_tpu.engine.patchmatch import run_patchmatch as jax_run
from acmmp_tpu.ops import median as jmed
from acmmp_tpu.ops import propagation as jprop
from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.engine.inputs import solver_inputs_from_numpy
from acmmp_tpu_torch.engine.patchmatch import Mode, run_patchmatch
from acmmp_tpu_torch.ops import keys
from acmmp_tpu_torch.ops import median as tmed
from acmmp_tpu_torch.ops import ncc as tncc
from acmmp_tpu_torch.ops import propagation as tprop

from .util import textured_plane_scene

torch.set_num_threads(1)

# pinned solve-level agreement (measured 0.853 / 0.988, see above)
SHARE_WITHIN_1PCT = 0.80
SHARE_WITHIN_5PCT = 0.97
INTERIOR = np.s_[10:38, 12:52]


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(0)
    H, W, V = 24, 40, 4
    x, y = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32))
    costs = rng.uniform(0, 2, size=(H, W)).astype(np.float32)
    costs[rng.uniform(size=costs.shape) < 0.1] = 2.0   # exact ties
    planes = rng.normal(size=(H, W, 4)).astype(np.float32)
    selected = rng.uniform(size=(H, W, V)) < 0.5
    ncc8 = rng.uniform(0, 2, size=(8, H, W, V)).astype(np.float32)
    flags = rng.uniform(size=(8, H, W)) < 0.9
    return dict(x=x, y=y, costs=costs, planes=planes, selected=selected,
                ncc8=ncc8, flags=flags, wt=np.float32(W - 3),
                ht=np.float32(H - 2))


@pytest.mark.parametrize("quirk", [False, True])
def test_best_neighbor_planes_bitwise(fields, quirk):
    f = fields
    jp = JaxParams(reproduce_right_far_quirk=quirk)
    tp = PatchMatchParams(reproduce_right_far_quirk=quirk)
    jc, jf = jprop.best_neighbor_planes(f["costs"], f["planes"], f["x"],
                                        f["y"], f["wt"], f["ht"], jp)
    tc, tf = tprop.best_neighbor_planes(
        _t(f["costs"]), _t(f["planes"]), _t(f["x"]), _t(f["y"]),
        _t(f["wt"]), _t(f["ht"]), tp)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_view_prior_bitwise(fields):
    f = fields
    want = jprop.view_prior(f["selected"], f["x"], f["y"], f["wt"], f["ht"],
                            JaxParams())
    got = tprop.view_prior(_t(f["selected"]), _t(f["x"]), _t(f["y"]),
                           _t(f["wt"]), _t(f["ht"]), PatchMatchParams())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("iteration", [0, 1])
def test_view_selection_core(fields, iteration):
    f = fields
    prior = np.asarray(jprop.view_prior(f["selected"], f["x"], f["y"],
                                        f["wt"], f["ht"], JaxParams()))
    mask = np.array([True, True, True, False])
    jk = jax.random.key(9)
    jw, jn, js = jprop.view_selection_core(
        f["ncc8"], f["flags"], prior, mask, f["x"], f["y"], jk, iteration,
        JaxParams())
    tw, tn, ts = tprop.view_selection_core(
        _t(f["ncc8"]), _t(f["flags"]), _t(prior), _t(mask), _t(f["x"]),
        _t(f["y"]), keys.from_key_data(jax.random.key_data(jk)), iteration,
        PatchMatchParams())
    same = (tw.numpy() == np.asarray(jw)).all(-1)
    assert same.mean() >= 0.998, same.mean()        # measured: 1.0
    np.testing.assert_array_equal(ts.numpy()[same], np.asarray(js)[same])
    np.testing.assert_array_equal(tn.numpy()[same], np.asarray(jn)[same])
    assert not tw.numpy()[..., 3].any()          # masked view never drawn


@pytest.mark.parametrize("parity", [0, 1])
def test_checkerboard_median_bitwise(fields, parity):
    f = fields
    rng = np.random.default_rng(parity)
    depth = rng.uniform(2, 10, size=f["costs"].shape).astype(np.float32)
    black = ((f["x"].astype(int) + f["y"].astype(int)) % 2) == 0
    mask = black if parity == 0 else ~black
    want = jmed.checkerboard_median(depth, f["costs"], f["x"], f["y"],
                                    f["wt"], f["ht"], mask, JaxParams())
    got = tmed.checkerboard_median(_t(depth), _t(f["costs"]), _t(f["x"]),
                                   _t(f["y"]), _t(f["wt"]), _t(f["ht"]),
                                   _t(mask), PatchMatchParams())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def solves():
    """One photometric solve in each package on the same inputs and key,
    and the port's solve again with 1e-5 noise on every ZNCC cost."""
    images, cams, plane_z = textured_plane_scene(n_views=4, width=64,
                                                 height=48)
    jp = JaxParams(patch_size=7, ncc_backend="jnp")
    jin = build_solver_inputs(images[0], images[1:], cams[0], cams[1:], jp,
                              pad_h=1, pad_w=1)
    key = jax.random.key(0)
    jfn = jax.jit(functools.partial(jax_run, params=jp, mode=JaxMode()))
    jout = jax.tree.map(np.asarray, jfn(jin, key))
    tin, tkey = solver_inputs_from_numpy(jax.tree.map(np.asarray, jin),
                                         jax.random.key_data(key),
                                         device="cpu")
    tp = PatchMatchParams(patch_size=7)
    tout = run_patchmatch(tin, tkey, tp, Mode())
    clean = tncc._zncc_grids
    gen = torch.Generator().manual_seed(0)

    def noisy(*args):
        cost = clean(*args)
        return cost + 1e-5 * torch.randn(cost.shape, generator=gen)

    tncc._zncc_grids = noisy
    try:
        tnoisy = run_patchmatch(tin, tkey, tp, Mode())
    finally:
        tncc._zncc_grids = clean
    return jout, tout, tnoisy, plane_z


def _shares(a, b):
    rel = np.abs(a[INTERIOR] - b[INTERIOR]) / np.abs(b[INTERIOR])
    return (rel < 0.01).mean(), (rel < 0.05).mean()


def test_solve_agrees_with_jax(solves):
    jout, tout, tnoisy, _ = solves
    port = tout.depth.numpy()
    assert np.isfinite(port).all()
    s1, s5 = _shares(port, jout.depth)
    n1, n5 = _shares(tnoisy.depth.numpy(), port)
    assert s1 >= SHARE_WITHIN_1PCT, (s1, n1)
    assert s5 >= SHARE_WITHIN_5PCT, (s5, n5)
    # no worse than the solve's own sensitivity to 1e-5 of cost noise
    assert s1 >= n1 - 0.05 and s5 >= n5 - 0.02, (s1, n1, s5, n5)


def test_port_solve_recovers_plane(solves):
    """The asserts of tests/test_patchmatch.py::test_photometric_recovers_plane
    on the port's own solve."""
    _, out, _, plane_z = solves
    err = np.abs(out.depth.numpy()[INTERIOR] - plane_z)
    assert np.median(err) < 0.15, np.median(err)
    assert (err < 0.5).mean() > 0.85, (err < 0.5).mean()
    cos = -out.normal_world.numpy()[INTERIOR][..., 2]
    assert np.median(cos) > 0.95
    assert np.median(out.cost.numpy()[INTERIOR]) < 0.2


def test_other_modes_raise():
    """A mode whose input is missing raises ValueError naming the field
    (photometric inputs carry none of the optional ones)."""
    images, cams, _ = textured_plane_scene(n_views=2, width=16, height=8)
    jin = build_solver_inputs(images[0], images[1:], cams[0], cams[1:],
                              JaxParams(), pad_h=1, pad_w=1)
    tin, tkey = solver_inputs_from_numpy(jax.tree.map(np.asarray, jin),
                                         np.zeros(2, np.uint32), device="cpu")
    missing = {Mode(geom_consistency=True): "init_depth",
               Mode(planar_prior=True): "init_depth",
               Mode(hierarchy=True): "init_depth",
               Mode(seeded=True): "seed_planes"}
    for mode, field in missing.items():
        with pytest.raises(ValueError, match=f"SolverInputs.{field}"):
            run_patchmatch(tin, tkey, PatchMatchParams(), mode)
    # with the re-entry maps given, the geometric mode still needs the
    # source depth maps, and the planar prior its prior planes
    h, w = tin.ref_img.shape
    tin = tin._replace(init_depth=torch.full((h, w), 5.0),
                       init_normal_world=torch.zeros((h, w, 3)),
                       init_cost=torch.zeros((h, w)))
    with pytest.raises(ValueError, match="src_depths"):
        run_patchmatch(tin, tkey, PatchMatchParams(),
                       Mode(geom_consistency=True))
    with pytest.raises(ValueError, match="prior_planes"):
        run_patchmatch(tin, tkey, PatchMatchParams(),
                       Mode(hierarchy=True, planar_prior=True))
