"""acmmp_tpu_torch geometry, keys, pixel RNG and random laws against their
acmmp_tpu twins on the same numpy-seeded inputs (CPU).

Tolerances: integer work (keys, pixel hashes, uniforms) is bitwise.
Float geometry and the random laws agree within 1e-5 relative: XLA:CPU
contracts a*b+c into fused multiply-adds and has its own exp/sin/cos,
while PyTorch rounds each product and uses its own libm, so the two differ
by a few ulp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmmp_tpu.core import geometry as jgeo
from acmmp_tpu.ops import pixel_rng as jrng
from acmmp_tpu.ops import sampling as jsamp
from acmmp_tpu_torch.core import geometry as tgeo
from acmmp_tpu_torch.ops import keys
from acmmp_tpu_torch.ops import pixel_rng as trng
from acmmp_tpu_torch.ops import sampling as tsamp

torch.set_num_threads(1)

RTOL = 1e-5


def _close(got, want, rtol=RTOL, atol=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _random_camera(rng, width=64, height=48):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    R = (q * np.sign(np.linalg.det(q))).astype(np.float32)
    f = rng.uniform(80, 200)
    K = np.array([[f, 0, (width - 1) / 2 + rng.uniform(-3, 3)],
                  [0, f * rng.uniform(0.95, 1.05),
                   (height - 1) / 2 + rng.uniform(-3, 3)],
                  [0, 0, 1]], np.float32)
    t = rng.normal(size=3).astype(np.float32)
    args = (K, R, t, float(width), float(height), 1.0, 20.0)
    return jgeo.Camera.from_numpy(*args), tgeo.Camera.from_numpy(*args)


@pytest.fixture(scope="module")
def cams():
    rng = np.random.default_rng(0)
    jref, tref = _random_camera(rng)
    srcs = [_random_camera(rng) for _ in range(3)]
    jsrc = jgeo.stack_cameras([s[0] for s in srcs])
    tsrc = tgeo.stack_cameras([s[1] for s in srcs])
    H, W = 48, 64
    x, y = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32))
    depth = rng.uniform(2, 10, size=(H, W)).astype(np.float32)
    n = rng.normal(size=(H, W, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return dict(jref=jref, tref=tref, jsrc=jsrc, tsrc=tsrc, x=x, y=y,
                depth=depth, n=n)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("fn", [
    "backproject", "view_direction", "dist_to_origin", "plane_roundtrip",
    "normal_frames", "face_camera", "homography_coeffs", "bilinear_sample",
    "pixel_grid"])
def test_geometry_matches_jnp(cams, fn):
    c = cams
    jr, tr = c["jref"], c["tref"]
    x, y, d, n = c["x"], c["y"], c["depth"], c["n"]
    if fn == "backproject":
        _close(tgeo.backproject(tr, _t(x), _t(y), _t(d)),
               jgeo.backproject(jr, x, y, d))
    elif fn == "view_direction":
        _close(tgeo.view_direction(tr, _t(x), _t(y), _t(d)),
               jgeo.view_direction(jr, x, y, d))
    elif fn == "dist_to_origin":
        _close(tgeo.dist_to_origin(tr, _t(x), _t(y), _t(d), _t(n)),
               jgeo.dist_to_origin(jr, x, y, d, n))
    elif fn == "plane_roundtrip":
        jp = jgeo.plane_from_depth_normal(jr, x, y, d, n)
        tp = tgeo.plane_from_depth_normal(tr, _t(x), _t(y), _t(d), _t(n))
        _close(tp, jp)
        _close(tgeo.depth_from_plane(tr, _t(jp), _t(x), _t(y)),
               jgeo.depth_from_plane(jr, jp, x, y))
    elif fn == "normal_frames":
        _close(tgeo.normal_cam_to_world(tr, _t(n)),
               jgeo.normal_cam_to_world(jr, n))
        _close(tgeo.normal_world_to_cam(tr, _t(n)),
               jgeo.normal_world_to_cam(jr, n))
    elif fn == "face_camera":
        _close(tgeo.face_camera(tr, _t(x), _t(y), _t(d), _t(n)),
               jgeo.face_camera(jr, x, y, d, n))
    elif fn == "homography_coeffs":
        jA, jB, jK = jax.vmap(lambda s: jgeo.homography_coeffs(jr, s))(
            c["jsrc"])
        tA, tB, tK = tgeo.homography_coeffs(tr, c["tsrc"])
        _close(tA, jA, atol=1e-4)
        _close(tB, jB, atol=1e-4)
        _close(tK, jK[0])
    elif fn == "bilinear_sample":
        rng = np.random.default_rng(5)
        img = rng.uniform(0, 255, size=(48, 64)).astype(np.float32)
        sx = rng.uniform(-5, 70, size=(48, 64)).astype(np.float32)
        sy = rng.uniform(-5, 55, size=(48, 64)).astype(np.float32)
        _close(tgeo.bilinear_sample(_t(img), _t(sx), _t(sy), 60.0, 45.0),
               jgeo.bilinear_sample(jnp.asarray(img), sx, sy, 60.0, 45.0))
    elif fn == "pixel_grid":
        tx, ty = tgeo.pixel_grid(48, 64)
        jx, jy = jgeo.pixel_grid(48, 64)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("seed", [0, 7, 123456789, 2 ** 31 - 1])
def test_keys_match_jax_key_data(seed):
    jk, tk = jax.random.key(seed), keys.key(seed)
    data = lambda k: np.asarray(jax.random.key_data(k))  # noqa: E731
    np.testing.assert_array_equal(tk.data, data(jk))
    for n in (2, 4):
        for j, t in zip(jax.random.split(jk, n), keys.split(tk, n)):
            np.testing.assert_array_equal(t.data, data(j))
    for d in (0, 1, 3, 1000):
        np.testing.assert_array_equal(keys.fold_in(tk, d).data,
                                      data(jax.random.fold_in(jk, d)))
    np.testing.assert_array_equal(keys.from_key_data(data(jk)).data,
                                  data(jk))


def _coords(offset=0):
    # includes negative (halo) coordinates, which wrap as int32 -> uint32
    y, x = np.meshgrid(np.arange(-8, 40, dtype=np.float32) + offset,
                       np.arange(-4, 60, dtype=np.float32), indexing="ij")
    return y, x


@pytest.mark.parametrize("salt", [0, 3, 16])
def test_pixel_rng_bitwise(salt):
    jk = jax.random.key(11)
    tk = keys.from_key_data(jax.random.key_data(jk))
    y, x = _coords()
    np.testing.assert_array_equal(
        trng.bits(tk, _t(y), _t(x), salt).numpy(),
        np.asarray(jrng.bits(jk, y, x, salt)).astype(np.int64))
    np.testing.assert_array_equal(
        trng.uniform(tk, _t(y), _t(x), salt).numpy(),
        np.asarray(jrng.uniform(jk, y, x, salt)))


@pytest.mark.parametrize("window", [0.0, 0.125])
def test_random_depth_both_laws(window):
    jk = jax.random.key(3)
    tk = keys.from_key_data(jax.random.key_data(jk))
    y, x = _coords()
    got = tsamp.random_depth(tk, torch.tensor(1.2), torch.tensor(24.0),
                             _t(y), _t(x), tile_window=window)
    want = jsamp.random_depth(jk, jnp.float32(1.2), jnp.float32(24.0), y, x,
                              tile_window=window)
    _close(got, want)


@pytest.mark.parametrize("min_cos", [0.0, 0.25])
def test_random_unit_normal_both_laws(cams, min_cos):
    jk = jax.random.key(4)
    tk = keys.from_key_data(jax.random.key_data(jk))
    c = cams
    got = tsamp.random_unit_normal(tk, c["tref"], _t(c["x"]), _t(c["y"]),
                                   _t(c["depth"]), min_cos=min_cos)
    want = jsamp.random_unit_normal(jk, c["jref"], c["x"], c["y"],
                                    c["depth"], min_cos=min_cos)
    _close(got, want)


def test_perturbed_normal(cams):
    jk = jax.random.key(5)
    tk = keys.from_key_data(jax.random.key_data(jk))
    c = cams
    n = jgeo.face_camera(c["jref"], c["x"], c["y"], c["depth"], c["n"])
    got = tsamp.perturbed_normal(tk, c["tref"], _t(c["x"]), _t(c["y"]),
                                 _t(n), 0.02 * np.pi)
    want = jsamp.perturbed_normal(jk, c["jref"], c["x"], c["y"], n,
                                  0.02 * np.pi)
    _close(got, want)


@pytest.mark.parametrize("window,min_cos", [(0.0, 0.0), (0.125, 0.25)])
def test_random_plane(cams, window, min_cos):
    jk = jax.random.key(6)
    tk = keys.from_key_data(jax.random.key_data(jk))
    c = cams
    got = tsamp.random_plane(tk, c["tref"], _t(c["x"]), _t(c["y"]),
                             torch.tensor(2.0), torch.tensor(10.0),
                             tile_window=window, min_cos=min_cos)
    want = jsamp.random_plane(jk, c["jref"], c["x"], c["y"],
                              jnp.float32(2.0), jnp.float32(10.0),
                              tile_window=window, min_cos=min_cos)
    _close(got, want, atol=1e-5)
