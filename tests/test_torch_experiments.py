"""The port's experiment harness against the JAX package's on the CPU: the
16-bit PNG codec of the seeded priors, camera-subset selection, prior
bootstrapping, the fixtures, the relief ground truth, the headless plots
and the five-method DTU grid.

Host numpy code is the same in both packages, so its bars are equality:
byte-equal folders and bitwise arrays. The port writes its 3-channel
16-bit normal PNGs without OpenCV, so their bytes differ from the JAX
package's; their decoded arrays (OpenCV's reading and the port's) are
held equal instead."""

import filecmp
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from acmmp_tpu.experiments import fixtures as jfix
from acmmp_tpu.experiments import prior_sampler as jps
from acmmp_tpu.experiments import select_cams as jsel
from acmmp_tpu.io import priors as jpriors
from acmmp_tpu.utils import synth as jsynth
from acmmp_tpu_torch.config import (FusionParams, PatchMatchParams,
                                    PipelineConfig)
from acmmp_tpu_torch.eval.dtu import METRIC_NAMES, dtu_metrics
from acmmp_tpu_torch.eval.stats import MetricTable
from acmmp_tpu_torch.experiments import fixtures as tfix
from acmmp_tpu_torch.experiments import prior_sampler as tps
from acmmp_tpu_torch.experiments import select_cams as tsel
from acmmp_tpu_torch.experiments import visualize as tvis
from acmmp_tpu_torch.experiments.dtu_analysis import analyze_scene
from acmmp_tpu_torch.io import priors as tpriors
from acmmp_tpu_torch.io import read_ply
from acmmp_tpu_torch.io.dense_folder import read_cam_txt
from acmmp_tpu_torch.utils import synth as tsynth

torch.set_num_threads(1)


def _tree(root):
    """Relative paths of every file under `root`."""
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def assert_same_tree(a, b, png_decoded=()):
    """Equal file lists and bytes, except the PNGs under the relative
    directories `png_decoded`, which must decode to equal arrays."""
    assert _tree(a) == _tree(b)
    for rel in _tree(a):
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if os.path.dirname(rel) in png_decoded:
            np.testing.assert_array_equal(
                cv2.imread(pa, cv2.IMREAD_UNCHANGED),
                cv2.imread(pb, cv2.IMREAD_UNCHANGED))
            np.testing.assert_array_equal(tpriors.read_png(pa),
                                          tpriors.read_png(pb))
        else:
            assert filecmp.cmp(pa, pb, shallow=False), rel


def _png_filtered(path, arr, kind):
    """A 16-bit PNG of uint16 `arr` ([H, W] or [H, W, 3] in OpenCV's BGR
    order) whose every row uses PNG filter `kind` (0-4), or row y filter
    `kind[y]` where `kind` is a sequence, written by this straightforward
    reference encoder."""
    h, w = arr.shape[:2]
    kinds = [kind] * h if np.isscalar(kind) else list(kind)
    samples = arr[..., ::-1] if arr.ndim == 3 else arr
    rows = np.ascontiguousarray(samples, ">u2").view(np.uint8).reshape(h, -1)
    bpp = 2 * (3 if arr.ndim == 3 else 1)
    out, prev = bytearray(), [0] * rows.shape[1]
    for row, kind in zip(rows.tolist(), kinds):
        enc = []
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b, c = prev[i], (prev[i - bpp] if i >= bpp else 0)
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = (0, a, b, (a + b) // 2,
                    a if pa <= pb and pa <= pc else
                    (b if pb <= pc else c))[kind]
            enc.append((x - pred) % 256)
        out += bytes([kind] + enc)
        prev = row

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, 16, 2 if arr.ndim == 3 else 0, 0,
                       0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(bytes(out)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, "mixed", "mixed_no_3_4"])
@pytest.mark.parametrize("channels", [1, 3])
def test_png_codec_reads_every_filter(tmp_path, kind, channels):
    """The port's reader undoes each PNG filter type as OpenCV does, alone
    and mixed row by row (with and without the Average and Paeth rows that
    send it down its diagonal-by-diagonal path)."""
    rng = np.random.default_rng(len(str(kind)))
    shape = (9, 13) if channels == 1 else (9, 13, 3)
    arr = rng.integers(0, 65536, shape, dtype=np.uint16)
    arr[::3] //= 7                       # rows where predictions matter
    if kind == "mixed":
        kind = [4, 3, 0, 1, 2, 4, 1, 3, 2]
    elif kind == "mixed_no_3_4":
        kind = [2, 1, 0, 2, 1, 1, 0, 2, 2]
    path = str(tmp_path / "f.png")
    _png_filtered(path, arr, kind)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                  arr)
    np.testing.assert_array_equal(tpriors.read_png(path), arr)


@pytest.mark.parametrize("flag", ["IMWRITE_PNG_FILTER_PAETH",
                                  "IMWRITE_PNG_FILTER_AVG",
                                  "IMWRITE_PNG_ALL_FILTERS"])
def test_png_codec_reads_opencv_filters(tmp_path, flag):
    """Normal priors that OpenCV wrote with the Average and Paeth row
    filters (its default is Sub) decode as OpenCV decodes them."""
    rng = np.random.default_rng(3)
    ys, xs = np.mgrid[0:40, 0:56].astype(np.float32)
    n = np.stack([np.sin(xs / 9) + 0.05 * rng.standard_normal(xs.shape),
                  np.cos(ys / 7), np.ones_like(xs)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    arr = np.clip((n + 1.0) * 32768.0, 0, 65535).astype(np.uint16)
    path = str(tmp_path / "n.png")
    assert cv2.imwrite(path, arr, [cv2.IMWRITE_PNG_FILTER,
                                   getattr(cv2, flag)])
    with open(path, "rb") as f:
        data = f.read()
    pos, idat = 8, b""
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        idat += data[pos + 8:pos + 8 + n] if tag == b"IDAT" else b""
        pos += 12 + n
    kinds = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        40, -1)[:, 0]
    assert np.isin(kinds, (3, 4)).any(), kinds
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                  arr)
    np.testing.assert_array_equal(tpriors.read_png(path), arr)


@pytest.mark.parametrize("shape", [(24, 32, 3), (5, 7, 3), (24, 32)])
def test_png_codec_against_opencv(tmp_path, shape):
    """The port's written PNG reads back through OpenCV as the array
    written (channel 0 on disk as blue), and OpenCV's PNG through the
    port's reader."""
    rng = np.random.default_rng(len(shape))
    arr = rng.integers(0, 65536, shape, dtype=np.uint16)
    ours, theirs = str(tmp_path / "t.png"), str(tmp_path / "c.png")
    tpriors.write_png16(ours, arr)
    cv2.imwrite(theirs, arr)
    for path in (ours, theirs):
        np.testing.assert_array_equal(
            cv2.imread(path, cv2.IMREAD_UNCHANGED), arr)
        np.testing.assert_array_equal(tpriors.read_png(path), arr)
    if len(shape) == 3:
        # PIL reads the 8 high bits of each sample in RGB order
        from PIL import Image as PILImage

        rgb = np.asarray(PILImage.open(ours).convert("RGB"))
        np.testing.assert_array_equal(rgb, (arr[..., ::-1] >> 8))


def test_priors_from_either_package_read_the_same(tmp_path):
    """Prior PNGs written by the JAX package (OpenCV) and by the port decode
    to bitwise the same seed planes in both packages."""
    _, cams, plane_z = tsynth.textured_plane_scene(n_views=2, width=40,
                                                   height=30)
    rng = np.random.default_rng(7)
    depth = (plane_z + 0.3 * rng.normal(size=(30, 40))).astype(np.float32)
    normal = rng.normal(size=(30, 40, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    jdense, tdense = str(tmp_path / "j"), str(tmp_path / "t")
    jpriors.write_prior_pngs(jdense, 0, depth, normal, 2.0, 10.0)
    tpriors.write_prior_pngs(tdense, 0, depth, normal, 2.0, 10.0)
    assert_same_tree(jdense, tdense, png_decoded=("priors/normals",))
    for rows, cols in ((30, 40), (15, 20)):
        want = jpriors.load_seed_planes(jdense, 0, cams[0], rows, cols)
        for dense in (jdense, tdense):
            np.testing.assert_array_equal(
                tpriors.load_seed_planes(dense, 0, cams[0], rows, cols), want)
            np.testing.assert_array_equal(
                jpriors.load_seed_planes(dense, 0, cams[0], rows, cols), want)


def test_calc_pairs_and_setup_from_source_match_jax(tmp_path):
    v = np.random.default_rng(0).normal(size=(12, 3)) + [0, 0, 3]
    for params in (tsel.ReconParams(minangle=3, maxangle=45, max_n_view=3),
                   tsel.ReconParams(minangle=0.01, maxangle=120)):
        jp = jsel.ReconParams(**vars(params))
        got = tsel.calc_pairs(v.copy(), params, np.random.default_rng(5))
        want = jsel.calc_pairs(v.copy(), jp, np.random.default_rng(5))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    src = tfix.write_synthetic_dense_folder(str(tmp_path / "src"), n_views=6,
                                            relief=True)
    for params in (tsel.ReconParams(minangle=0.01, maxangle=120,
                                    max_n_view=2),
                   tsel.ReconParams()):
        tdst = tsel.setup_from_source([0, 2, 5, 3], src, str(tmp_path / "t"),
                                      params, seed=3)
        jdst = jsel.setup_from_source([0, 2, 5, 3], src, str(tmp_path / "j"),
                                      jsel.ReconParams(**vars(params)),
                                      seed=3)
        assert_same_tree(tdst, jdst)


def test_prior_sampler_matches_jax(tmp_path):
    _, cams, plane_z = tsynth.textured_plane_scene(n_views=3, width=64,
                                                   height=48)
    rng = np.random.default_rng(8)
    pts = np.stack([rng.uniform(-2, 2, 20000), rng.uniform(-2, 2, 20000),
                    plane_z + 0.2 * np.sin(rng.uniform(0, 6, 20000))], 1)
    for cam in cams:
        depth = tps.render_depth_from_points(pts, cam, 64, 48, 2.0, 10.0)
        np.testing.assert_array_equal(
            depth, jps.render_depth_from_points(pts, cam, 64, 48, 2.0, 10.0))
        assert (depth > 0).mean() > 0.9
        np.testing.assert_array_equal(tps.normals_from_depth(depth, cam),
                                      jps.normals_from_depth(depth, cam))
    tdense, jdense = str(tmp_path / "t"), str(tmp_path / "j")
    tps.write_priors_from_points(tdense, pts, cams)
    jps.write_priors_from_points(jdense, pts, cams)
    assert_same_tree(tdense, jdense, png_decoded=("priors/normals",))


@pytest.mark.parametrize("relief", [False, True])
def test_fixtures_match_jax(tmp_path, relief):
    t = tfix.write_synthetic_dense_folder(str(tmp_path / "t"), n_views=3,
                                          width=40, height=32, relief=relief)
    j = jfix.write_synthetic_dense_folder(str(tmp_path / "j"), n_views=3,
                                          width=40, height=32, relief=relief)
    assert_same_tree(t, j)
    assert tfix.write_random_priors(t, seed=2) == jfix.write_random_priors(
        j, seed=2) == 3
    assert_same_tree(t, j, png_decoded=("priors/depths", "priors/normals"))
    assert tpriors.priors_available(t, 3)
    tfix.rewrite_depth_ranges(t, 1.5, 9.0, steps=128)
    jfix.rewrite_depth_ranges(j, 1.5, 9.0, steps=128)
    for d in (t, j):
        os.makedirs(os.path.join(d, "ACMMP"))
        open(os.path.join(d, "model.ply"), "w").close()
    tfix.clean_outputs(t)
    jfix.clean_outputs(j)
    assert_same_tree(t, j, png_decoded=("priors/depths", "priors/normals"))
    assert read_cam_txt(os.path.join(t, "cams", "00000001_cam.txt")
                        ).depth_max == 9.0


def test_relief_gt_points_bitwise():
    _, cams, _ = tsynth.textured_relief_scene(n_views=3, width=48,
                                              height=32, spread=1.2,
                                              converge=True)
    got = tsynth.relief_gt_points(cams, 48, 32, samples=(24, 40))
    want = jsynth.relief_gt_points(cams, 48, 32, samples=(24, 40))
    assert got.shape == (3 * 24 * 40, 3)
    np.testing.assert_array_equal(got, want)


def test_visualize_headless(tmp_path):
    table = MetricTable()
    rng = np.random.default_rng(0)
    for method in ("no_prior", "boost_1"):
        for scan in ("scan1", "scan6"):
            for ncam in (2, 5):
                table.add(method, scan, ncam,
                          {k: float(rng.uniform(0, 1)) for k in METRIC_NAMES})
    _, cams, _ = tsynth.textured_plane_scene(n_views=3)
    pts = rng.normal(size=(3000, 3)).astype(np.float32)
    from acmmp_tpu_torch.io import write_ply

    ply = str(tmp_path / "cloud.ply")
    write_ply(ply, pts, np.zeros_like(pts),
              rng.integers(0, 255, (3000, 3)).astype(np.uint8))
    paths = [
        tvis.plot_metric_vs_cams(table, "acc_median", str(tmp_path / "m.png")),
        tvis.plot_point_counts(
            {"no_prior": {2: 100.0, 5: 200.0},
             "boost_1": {2: 150.0, 5: 220.0}},
            str(tmp_path / "c.png"), baseline_method="no_prior"),
        tvis.plot_depth_map(rng.uniform(1, 5, (32, 48)),
                            str(tmp_path / "d.png"),
                            cost=rng.uniform(0, 2, (32, 48))),
        tvis.plot_cameras(cams, str(tmp_path / "cams.png"), points=pts),
        tvis.render_cloud_screenshot(ply, str(tmp_path / "s.png"),
                                     width=160, height=120),
    ]
    for p in paths:
        assert os.path.getsize(p) > 1000, p


def test_analyze_scene_five_method_grid(tmp_path):
    """The port's analyze_scene on the CPU on the scene of the JAX
    package's test of the same name: five PLYs, none empty, scored into
    one MetricTable. The five pipelines run one red/black iteration per
    solve and fuse a point seen by one other view (the JAX test: two
    iterations, two views): a run of the path that holds its outputs,
    not an agreement with the JAX package."""
    images, cams, plane_z = tsynth.textured_plane_scene(n_views=4, width=64,
                                                        height=48)
    dense = tsynth.write_dense_folder(str(tmp_path / "d"), images, cams)
    cfg = PipelineConfig(
        patchmatch=PatchMatchParams(patch_size=7, max_iterations=1),
        fusion=FusionParams(num_consistent_thresh=1),
        pad_h=1, pad_w=1,
    )
    xs, ys = np.meshgrid(np.linspace(-1.5, 1.5, 60),
                         np.linspace(-1.1, 1.1, 45))
    gt = np.stack([xs.ravel(), ys.ravel(),
                   np.full(xs.size, plane_z)], axis=1)
    plys = analyze_scene(dense, cfg, gt_points=gt, device="cpu")
    expected = {"no_prior", "x2", "boost_1", "boost_single", "full_prior"}
    assert set(plys) == expected, sorted(plys)
    table = MetricTable()
    for method, ply in plys.items():
        pts, _, _ = read_ply(ply)
        assert len(pts) > 0, method
        assert np.median(np.abs(pts[:, 2] - plane_z)) < 0.1, method
        table.add(method, "synth", 3, dtu_metrics(pts, gt, dst=0.0))
    assert set(table.methods()) == expected
    assert all(np.isfinite(table.rows[k]).all() for k in table.rows)
