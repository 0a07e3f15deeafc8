"""acmmp_tpu_torch's plain ZNCC, top-k init and parity packing against
acmmp_tpu on the same inputs (CPU): the 128x32, 3-source scene of
tests/test_pallas_ncc.py, shipping PatchMatchParams() (36 taps).

The plain ZNCC is held to the JAX package's own kernel bar (fewer than
0.1% of costs may differ by more than 2e-3 + 1e-3 |ref|,
tests/test_pallas_ncc.py) against the jnp oracle, and once against the
Pallas kernel in interpret mode. The two f32 evaluations differ in
rounding (XLA:CPU fuses multiply-adds and has its own exp; the port
centres its moments), which the one-pass variance amplifies. Top-k init
and parity packing are bitwise. The CUDA kernel itself runs only on a
card: chip_smoke.py holds it against this plain version there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from acmmp_tpu.config import PatchMatchParams as JaxParams
from acmmp_tpu.core import geometry as jgeo
from acmmp_tpu.engine.inputs import build_solver_inputs
from acmmp_tpu.ops import ncc as jncc
from acmmp_tpu.ops import parity as jparity
from acmmp_tpu.ops import sampling as jsamp
from acmmp_tpu.ops.pallas_ncc import multiview_zncc_pallas
from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.engine.inputs import solver_inputs_from_numpy
from acmmp_tpu_torch.ops import ncc as tncc
from acmmp_tpu_torch.ops import parity as tparity

from .util import textured_plane_scene

torch.set_num_threads(1)

JP = JaxParams(ncc_backend="jnp")
TP = PatchMatchParams()


def _zncc_bar(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    bad = np.abs(got - want) > 2e-3 + 1e-3 * np.abs(want)
    assert bad.mean() < 1e-3, (
        f"{bad.mean():.5f} of costs differ; max |d|="
        f"{np.abs(got - want).max()}")


@pytest.fixture(scope="module")
def scene():
    images, cams, plane_z = textured_plane_scene(n_views=3, width=128,
                                                 height=32)
    # one padded view slot: n_views (2) < V (3)
    jin = build_solver_inputs(images[0], images[1:], cams[0], cams[1:], JP,
                              num_views_pad=3)
    tin, _ = solver_inputs_from_numpy(jax.tree.map(np.asarray, jin),
                                      np.zeros(2, np.uint32), device="cpu")
    H, W = jin.ref_img.shape
    x, y = jgeo.pixel_grid(H, W)
    n = jnp.broadcast_to(jnp.asarray([0.0, 0.0, -1.0]), x.shape + (3,))
    n_cam = jgeo.normal_world_to_cam(jin.ref_cam, n)
    coherent = []
    for k in range(8):   # the true plane at depths 1 +- 2% per k
        d = jnp.full(x.shape, plane_z * (1.0 + 0.02 * (k - 4)))
        coherent.append(jgeo.plane_from_depth_normal(jin.ref_cam, x, y, d,
                                                     n_cam))
    rand = [jsamp.random_plane(k, jin.ref_cam, x, y, jin.depth_min,
                               jin.depth_max, tile_window=0.125,
                               min_cos=0.25)
            for k in jax.random.split(jax.random.key(3), 8)]
    return dict(jin=jin, tin=tin,
                jvg=jncc.make_view_geometry(jin.ref_cam, jin.src_cams),
                tvg=tncc.make_view_geometry(tin.ref_cam, tin.src_cams),
                coherent=np.array(jnp.stack(coherent)),
                random=np.array(jnp.stack(rand)))


_jit_full = jax.jit(jncc.multiview_zncc, static_argnames=("params",))
_jit_packed = jax.jit(jncc.multiview_zncc_packed, static_argnames=("params",))


@pytest.mark.parametrize("field,K,off0,origin", [
    ("coherent", 1, None, None), ("random", 1, None, None),
    ("coherent", 8, None, None), ("random", 8, 0, None),
    ("coherent", 8, 1, None), ("random", 2, 1, None),
    ("coherent", 3, 0, None), ("random", 2, None, (8.0, 0.0)),
    ("coherent", 3, 1, (16.0, 0.0))])
def test_plain_zncc_matches_jnp_oracle(scene, field, K, off0, origin):
    s = scene
    jin, tin = s["jin"], s["tin"]
    planes = s[field][:K]
    jorigin = None if origin is None else tuple(map(jnp.float32, origin))
    if off0 is None:
        want = _jit_full(jin.ref_img, jin.src_imgs, s["jvg"], planes, JP,
                         origin=jorigin)
        got = tncc.multiview_zncc(tin.ref_img, tin.src_imgs, s["tvg"],
                                  torch.as_tensor(planes), TP, origin=origin,
                                  n_views=2)
    else:
        packed = np.array(jparity.pack_rows_c(planes, jnp.int32(off0)))
        want = _jit_packed(jin.ref_img, jin.src_imgs, s["jvg"], packed, JP,
                           jnp.int32(off0), origin=jorigin)
        got = tncc.multiview_zncc_packed(
            tin.ref_img, tin.src_imgs, s["tvg"], torch.as_tensor(packed),
            TP, off0, origin=origin, n_views=2)
    # the padded slot is masked downstream in both packages
    _zncc_bar(got.numpy()[..., :2], np.asarray(want)[..., :2])


def test_plain_zncc_matches_pallas_interpret(scene):
    s = scene
    jin, tin = s["jin"], s["tin"]
    planes = s["random"][:2]
    with pltpu.force_tpu_interpret_mode():
        want = multiview_zncc_pallas(jin.ref_img, jin.src_imgs, s["jvg"],
                                     jnp.asarray(planes), JaxParams(),
                                     n_views=jnp.int32(2))
    got = tncc.multiview_zncc(tin.ref_img, tin.src_imgs, s["tvg"],
                              torch.as_tensor(planes), TP, n_views=2)
    _zncc_bar(got.numpy()[..., :2], np.asarray(want)[..., :2])
    # the Pallas kernel writes cost_max into the padded view slot
    np.testing.assert_array_equal(np.asarray(want)[..., 2:], 2.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_initial_cost_and_views_bitwise(seed):
    rng = np.random.default_rng(seed)
    costs = rng.uniform(0, 2.2, size=(16, 24, 5)).astype(np.float32)
    costs[rng.uniform(size=costs.shape) < 0.3] = 2.0   # clipped views
    costs[3, 4] = 2.0                                  # no valid view
    mask = np.array([True, True, False, True, True])
    jc, js = jncc.initial_cost_and_views(costs, mask, JP)
    tc, ts = tncc.initial_cost_and_views(torch.as_tensor(costs),
                                         torch.as_tensor(mask), TP)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("off0", [0, 1])
def test_parity_pack_unpack_bitwise(off0):
    rng = np.random.default_rng(off0)
    a = rng.normal(size=(3, 16, 24)).astype(np.float32)
    c = rng.normal(size=(16, 24, 4)).astype(np.float32)
    o = jnp.int32(off0)
    np.testing.assert_array_equal(
        tparity.pack_rows(torch.as_tensor(a), off0).numpy(),
        np.asarray(jparity.pack_rows(a, o)))
    packed_c = tparity.pack_rows_c(torch.as_tensor(c), off0)
    np.testing.assert_array_equal(packed_c.numpy(),
                                  np.asarray(jparity.pack_rows_c(c, o)))
    np.testing.assert_array_equal(
        tparity.unpack_rows(torch.as_tensor(a)).numpy(),
        np.asarray(jparity.unpack_rows(a)))
    np.testing.assert_array_equal(
        tparity.unpack_rows_c(packed_c).numpy(),
        np.asarray(jparity.unpack_rows_c(jparity.pack_rows_c(c, o))))
    mask = (np.add.outer(np.arange(16), np.arange(24)) % 2) == off0
    assert tparity.row_pack_offset(torch.as_tensor(mask)) == int(
        jparity.row_pack_offset(mask))


def test_packed_matches_full_grid(scene):
    """Packed evaluation equals the full-grid evaluation at the packed
    pixels (the JAX package pins the same for its kernels)."""
    s = scene
    tin = s["tin"]
    planes = torch.as_tensor(s["random"][:2])
    full = tncc.multiview_zncc(tin.ref_img, tin.src_imgs, s["tvg"], planes,
                               TP)                        # [K, H, W, V]
    for off0 in (0, 1):
        packed = tncc.multiview_zncc_packed(
            tin.ref_img, tin.src_imgs, s["tvg"],
            tparity.pack_rows_c(planes, off0), TP, off0)
        want = tparity.pack_rows(full.permute(0, 3, 1, 2), off0)
        np.testing.assert_allclose(packed.numpy(),
                                   want.permute(0, 2, 3, 1).numpy(),
                                   rtol=1e-6, atol=1e-6)
