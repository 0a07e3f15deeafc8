"""acmmp_tpu_torch's joint bilateral upsampling and planar-prior
construction against acmmp_tpu on the same inputs (CPU).

JBU is held at 1e-5 in both of its sampling forms: the static-shift form
of an integer ratio (2, the pipeline's scale step) and the gather form of
a non-integer one (2.5). The planar prior is numpy and scipy in both
packages, so it is bitwise, on the output of a port photometric solve."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmmp_tpu.config import PatchMatchParams as JaxParams
from acmmp_tpu.engine.priors import build_planar_prior as jax_prior
from acmmp_tpu.ops import jbu as jjbu
from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.engine.inputs import build_solver_inputs
from acmmp_tpu_torch.engine.patchmatch import Mode, run_patchmatch
from acmmp_tpu_torch.engine.priors import build_planar_prior
from acmmp_tpu_torch.ops import jbu as tjbu
from acmmp_tpu_torch.ops import keys
from acmmp_tpu_torch.utils.synth import textured_plane_scene

torch.set_num_threads(1)

# (coarse, fine) shapes: ratio 2 takes the static-shift form, 2.5 the
# gather form
SHAPES = {"ratio2": ((12, 16), (24, 32)), "ratio2.5": ((12, 16), (30, 40))}


def _fields(name):
    (hc, wc), (h, w) = SHAPES[name]
    rng = np.random.default_rng(0)
    fine = rng.uniform(0, 255, (h, w)).astype(np.float32)
    depth = rng.uniform(2.0, 8.0, (hc, wc)).astype(np.float32)
    normal = rng.normal(size=(hc, wc, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    cost = rng.uniform(0.0, 2.0, (hc, wc)).astype(np.float32)
    return fine, depth, normal, cost


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_jbu_depth_matches_jax(name):
    fine, depth, _, _ = _fields(name)
    got = tjbu.jbu_depth(torch.as_tensor(fine), torch.as_tensor(depth),
                         PatchMatchParams())
    want = jjbu.jbu_depth(jnp.asarray(fine), jnp.asarray(depth), JaxParams())
    assert got.shape == fine.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_jbu_normal_cost_matches_jax(name):
    fine, _, normal, cost = _fields(name)
    gn, gc = tjbu.jbu_normal_cost(torch.as_tensor(fine),
                                  torch.as_tensor(normal),
                                  torch.as_tensor(cost), PatchMatchParams())
    wn, wc = jjbu.jbu_normal_cost(jnp.asarray(fine), jnp.asarray(normal),
                                  jnp.asarray(cost), JaxParams())
    np.testing.assert_allclose(gn.numpy(), np.asarray(wn), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-5,
                               atol=1e-5)


def test_static_shift_and_gather_forms_agree():
    """The two sampling forms read the same coarse values."""
    fine, depth, normal, _ = _fields("ratio2")
    t = torch.as_tensor
    for coarse in (t(depth), t(normal)):
        static = tjbu._make_sampler(coarse, fine.shape)
        flat = coarse.reshape((-1,) + tuple(coarse.shape[2:]))
        H, W = fine.shape
        for j, i, ry, rx, _w in tjbu._weights(t(fine), depth.shape, 2, 0.5,
                                              PatchMatchParams()):
            gathered = flat[(ry * 16 + rx).reshape(-1)].reshape(
                (H, W) + tuple(coarse.shape[2:]))
            assert torch.equal(static(j, i, ry, rx), gathered)


def test_planar_prior_bitwise():
    images, cams, _ = textured_plane_scene(n_views=3, width=64, height=48)
    params = PatchMatchParams(patch_size=7)
    inputs = build_solver_inputs(images[0], images[1:], cams[0], cams[1:],
                                 params, pad_h=1, pad_w=1, device="cpu")
    out = run_patchmatch(inputs, keys.key(0), params, Mode())
    depth, cost = out.depth.numpy(), out.cost.numpy()
    h, w = images[0].shape
    dmin = float(cams[0].depth_min * params.depth_min_relax)
    dmax = float(cams[0].depth_max * params.depth_max_relax)
    got = build_planar_prior(cams[0], depth, cost, dmin, dmax, w, h)
    want = jax_prior(cams[0], depth, cost, dmin, dmax, w, h)
    assert got[0] is not None and got[1].any()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
