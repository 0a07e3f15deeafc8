"""One whole geometric-consistency solve of acmmp_tpu_torch against
acmmp_tpu on the same inputs and key (CPU), in a file of its own so its
one JAX compile runs beside the other test files.

The setup is tests/test_patchmatch.py::test_geometric_pass_refines (64x48,
4 views, patch_size=7). The source and init depths come from the port's
own photometric solves of every view, and both packages take the same
arrays, so only the JAX geometric program compiles. As for the
photometric solve (tests/test_torch_solver.py), the comparison is the
share of interior depths within 1% and 5% of the JAX solve, held to the
port's agreement with itself under 1e-5 of ZNCC cost noise: argmin
near-ties flip winners, and the solve amplifies f32 rounding. Measured
(this test, CPU): port vs JAX 99.55% within 1% and 100% within 5%; port
vs noisy port 99.46% and 99.91%. The re-entry from converged depths
leaves fewer near-ties than a random init, so the shares are higher than
the photometric solve's. The test pins 0.97 and 0.99 (ROADMAP.md rules).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from acmmp_tpu.config import PatchMatchParams as JaxParams
from acmmp_tpu.engine.inputs import build_solver_inputs as jax_inputs
from acmmp_tpu.engine.patchmatch import Mode as JaxMode
from acmmp_tpu.engine.patchmatch import run_patchmatch as jax_run
from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.engine.inputs import (build_solver_inputs,
                                           solver_inputs_from_numpy)
from acmmp_tpu_torch.engine.patchmatch import Mode, run_patchmatch
from acmmp_tpu_torch.ops import keys
from acmmp_tpu_torch.ops import ncc as tncc
from acmmp_tpu_torch.utils.synth import textured_plane_scene

from .util import textured_plane_scene as jax_scene

torch.set_num_threads(1)

# pinned solve-level agreement (measured 0.9955 / 1.0, see above)
SHARE_WITHIN_1PCT = 0.97
SHARE_WITHIN_5PCT = 0.99
INTERIOR = np.s_[10:38, 12:52]
TP = PatchMatchParams(patch_size=7)
JP = JaxParams(patch_size=7, ncc_backend="jnp")


@pytest.fixture(scope="module")
def solves():
    images, cams, plane_z = textured_plane_scene(n_views=4, width=64,
                                                 height=48)
    # per-view photometric solves (view i as reference, key i), as
    # test_geometric_pass_refines builds them
    depths, normals, costs = {}, {}, {}
    for i in range(len(images)):
        order = [i] + [j for j in range(len(images)) if j != i]
        inp = build_solver_inputs(images[i], [images[j] for j in order[1:]],
                                  cams[i], [cams[j] for j in order[1:]], TP,
                                  pad_h=1, pad_w=1, device="cpu")
        o = run_patchmatch(inp, keys.key(i), TP, Mode())
        depths[i], normals[i], costs[i] = (o.depth.numpy(),
                                           o.normal_world.numpy(),
                                           o.cost.numpy())
    jimages, jcams, _ = jax_scene(n_views=4, width=64, height=48)
    jin = jax_inputs(jimages[0], jimages[1:], jcams[0], jcams[1:], JP,
                     pad_h=1, pad_w=1,
                     src_depths=[depths[j] for j in range(1, 4)],
                     init_depth=depths[0], init_normal_world=normals[0],
                     init_cost=costs[0])
    key = jax.random.key(0)
    mode = JaxMode(geom_consistency=True)
    jfn = jax.jit(functools.partial(jax_run, params=JP, mode=mode))
    jout = jax.tree.map(np.asarray, jfn(jin, key))
    tin, tkey = solver_inputs_from_numpy(jax.tree.map(np.asarray, jin),
                                         jax.random.key_data(key),
                                         device="cpu")
    tmode = Mode(geom_consistency=True)
    tout = run_patchmatch(tin, tkey, TP, tmode)
    clean = tncc._zncc_grids
    gen = torch.Generator().manual_seed(0)

    def noisy(*args):
        cost = clean(*args)
        return cost + 1e-5 * torch.randn(cost.shape, generator=gen)

    tncc._zncc_grids = noisy
    try:
        tnoisy = run_patchmatch(tin, tkey, TP, tmode)
    finally:
        tncc._zncc_grids = clean
    return jout, tout, tnoisy, depths[0], plane_z


def _shares(a, b):
    rel = np.abs(a[INTERIOR] - b[INTERIOR]) / np.abs(b[INTERIOR])
    return (rel < 0.01).mean(), (rel < 0.05).mean()


def test_geom_solve_agrees_with_jax(solves):
    jout, tout, tnoisy, _, _ = solves
    port = tout.depth.numpy()
    assert np.isfinite(port).all()
    s1, s5 = _shares(port, jout.depth)
    n1, n5 = _shares(tnoisy.depth.numpy(), port)
    assert s1 >= SHARE_WITHIN_1PCT, (s1, n1)
    assert s5 >= SHARE_WITHIN_5PCT, (s5, n5)
    # no worse than the solve's own sensitivity to 1e-5 of cost noise
    assert s1 >= n1 - 0.05 and s5 >= n5 - 0.02, (s1, n1, s5, n5)


def test_port_geometric_pass_refines(solves):
    """The asserts of tests/test_patchmatch.py::test_geometric_pass_refines
    on the port's own solves."""
    _, tout, _, depth0, plane_z = solves
    err_g = np.abs(tout.depth.numpy()[INTERIOR] - plane_z)
    err_0 = np.abs(depth0[INTERIOR] - plane_z)
    assert np.median(err_g) <= np.median(err_0) * 1.5
    assert np.median(err_g) < 0.15
    assert (err_g < 0.5).mean() > 0.85

