"""The disk contract of acmmp_tpu_torch against acmmp_tpu (CPU): .dmb and
PLY bytes, cam.txt / pair.txt, the bilinear resize, the multi-scale
settings and the seeded priors.

The JAX package writes .dmb and PLY files and resizes images through its
native host library when it builds (it does here); the port has only the
numpy path. Bars: bytes and arrays equal, except `load_seed_planes`
(1e-6: the same numpy expression on the same PNGs)."""

import os

import numpy as np
import pytest
import torch

from acmmp_tpu import native
from acmmp_tpu.config import PatchMatchParams as JaxParams
from acmmp_tpu.io import dense_folder as jdf
from acmmp_tpu.io import dmb as jdmb
from acmmp_tpu.io import ply as jply
from acmmp_tpu.io import priors as jpriors
from acmmp_tpu.pipeline import scheduler as jsched
from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.io import dense_folder as tdf
from acmmp_tpu_torch.io import dmb as tdmb
from acmmp_tpu_torch.io import ply as tply
from acmmp_tpu_torch.io import priors as tpriors
from acmmp_tpu_torch.pipeline import scheduler as tsched
from acmmp_tpu_torch.utils.synth import textured_plane_scene, write_dense_folder

torch.set_num_threads(1)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native library, which its writers and resize use
    when it builds; the cross-package bars are against that path."""
    if native.get_lib() is None:
        pytest.fail("the JAX package's native host library did not build")
    return native


@pytest.mark.parametrize("shape", [(5, 7), (6, 4, 3)])
def test_dmb_bytes_equal_both_ways(tmp_path, jax_native, shape):
    arr = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    arr.flat[3] = np.nan
    jpath, tpath = tmp_path / "j.dmb", tmp_path / "t.dmb"
    jdmb.write_dmb(jpath, arr)
    tdmb.write_dmb(tpath, arr)
    assert _bytes(jpath) == _bytes(tpath)
    for got in (tdmb.read_dmb(jpath), jdmb.read_dmb(tpath)):
        assert got.shape == shape and got.dtype == np.float32
        np.testing.assert_array_equal(got, arr)


def test_ply_bytes_equal_and_cross_read(tmp_path, jax_native):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    pts[7, 1] = np.inf                  # zeroed by both writers
    pts[9, 0] = np.nan
    nrm = rng.normal(size=(50, 3)).astype(np.float32)
    col = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    jpath, tpath = tmp_path / "j.ply", tmp_path / "t.ply"
    jply.write_ply(jpath, pts, nrm, col)
    tply.write_ply(tpath, pts, nrm, col)
    assert _bytes(jpath) == _bytes(tpath)
    want = pts.copy()
    want[[7, 9]] = 0.0
    for reader, path in ((tply.read_ply, jpath), (jply.read_ply, tpath)):
        p, n, c = reader(path)
        np.testing.assert_array_equal(p, want)
        np.testing.assert_array_equal(n, nrm)
        np.testing.assert_array_equal(c, col)


def test_cam_and_pair_round_trip(tmp_path):
    _, cams, _ = textured_plane_scene(n_views=2)
    cam = cams[1]
    tpath, jpath = tmp_path / "t_cam.txt", tmp_path / "j_cam.txt"
    tdf.write_cam_txt(tpath, cam)
    jdf.write_cam_txt(jpath, cam)
    assert _bytes(tpath) == _bytes(jpath)
    for got in (jdf.read_cam_txt(tpath), tdf.read_cam_txt(jpath)):
        for f in ("K", "R", "t"):
            np.testing.assert_array_equal(getattr(got, f), getattr(cam, f))
        assert (got.depth_min, got.depth_max) == (cam.depth_min,
                                                  cam.depth_max)

    pairs = [(0, [(1, 12.5), (2, 0.0), (3, 3.25)]), (1, [(0, 7.0)]),
             (2, []), (3, [(2, -1.0), (0, 9.0)])]
    tpath, jpath = tmp_path / "t_pair.txt", tmp_path / "j_pair.txt"
    tdf.write_pair_txt(tpath, pairs)
    jdf.write_pair_txt(jpath, pairs)
    assert _bytes(tpath) == _bytes(jpath)
    got, want = tdf.read_pair_txt(jpath), jdf.read_pair_txt(tpath)
    assert [(p.ref_image_id, p.src_image_ids) for p in got] == [
        (p.ref_image_id, p.src_image_ids) for p in want]
    # score <= 0 drops the source (GenerateSampleList)
    assert [p.src_image_ids for p in tdf.read_pair_txt(tpath)] == [
        [1, 3], [0], [], [0]]


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("shape", [(48, 64), (37, 53, 3)])
@pytest.mark.parametrize("factor", [0.5, 0.37, 1.7])
def test_resize_bitwise_against_native(jax_native, dtype, shape, factor):
    """The port's numpy resize against the JAX package's native path,
    bitwise (measured gap 0 on every case, also at 1600x1184 -> 800x592)."""
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, shape).astype(dtype)
    w, h = int(round(shape[1] * factor)), int(round(shape[0] * factor))
    got = tdf.resize_image(img, w, h)
    want = jdf.resize_image(img, w, h)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_rescale_to_max_size_equal(jax_native):
    images, cams, _ = textured_plane_scene(n_views=1, width=64, height=48)
    for max_size in (64, 40, 23):
        ti, tc = tdf.rescale_to_max_size(images[0], cams[0], max_size)
        ji, jc = jdf.rescale_to_max_size(images[0], cams[0], max_size)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tc.K, jc.K)
        assert (tc.width, tc.height) == (jc.width, jc.height)


def test_multiscale_settings_equal(tmp_path):
    images, cams, _ = textured_plane_scene(n_views=3, width=96, height=40)
    images[2] = images[2][:, :70]       # a smaller view
    dense = write_dense_folder(str(tmp_path / "scene"), images, cams)
    for size_bound in (1000, 48, 20):
        tp = tsched.generate_sample_list(dense)
        jp = jsched.generate_sample_list(dense)
        tn = tsched.compute_multiscale_settings(
            dense, tp, PatchMatchParams(size_bound=size_bound,
                                        max_image_size=90))
        jn = jsched.compute_multiscale_settings(
            dense, jp, JaxParams(size_bound=size_bound, max_image_size=90))
        assert tn == jn
        assert [(p.max_image_size, p.num_downscale) for p in tp] == [
            (p.max_image_size, p.num_downscale) for p in jp]


def test_seed_planes_match_on_jax_pngs(tmp_path):
    """Prior PNGs written by the JAX package decode to the same planes
    (1e-6); the port's writer writes the same depth PNG bytes, and normal
    PNGs (its own codec, not OpenCV) that decode to the same arrays."""
    images, cams, plane_z = textured_plane_scene(n_views=2, width=32,
                                                 height=24)
    rng = np.random.default_rng(4)
    depth = (plane_z + 0.3 * rng.normal(size=(24, 32))).astype(np.float32)
    normal = rng.normal(size=(24, 32, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    jdense, tdense = str(tmp_path / "j"), str(tmp_path / "t")
    for i in range(2):
        jpriors.write_prior_pngs(jdense, i, depth, normal, 2.0, 10.0)
        tpriors.write_prior_pngs(tdense, i, depth, normal, 2.0, 10.0)
    def png(dense, sub):
        return os.path.join(dense, "priors", sub, "00000001.png")

    assert _bytes(png(jdense, "depths")) == _bytes(png(tdense, "depths"))
    np.testing.assert_array_equal(tpriors.read_png(png(jdense, "normals")),
                                  tpriors.read_png(png(tdense, "normals")))
    assert tpriors.priors_available(jdense, 2)
    assert not tpriors.priors_available(jdense, 3)
    for rows, cols in ((24, 32), (12, 16)):
        got = tpriors.load_seed_planes(jdense, 1, cams[1], rows, cols)
        want = jpriors.load_seed_planes(jdense, 1, cams[1], rows, cols)
        assert got.shape == (rows, cols, 4)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert tpriors.load_seed_planes(jdense, 5, cams[1], 24, 32) is None
