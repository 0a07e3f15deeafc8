"""The port's COLMAP ingestion (io/colmap.py) and its command line
(acmmp_tpu_torch.cli) against the JAX package's on the CPU.

Every subcommand that reads or writes files runs through both packages'
``cli.main`` on the same inputs. Bars: byte-equal folders and equal
stdout, except the port's 16-bit prior PNGs, written without OpenCV,
which must decode to the JAX package's arrays. ``analyze-dtu`` runs on
folders whose five variant PLYs already exist (the grid is idempotent per
variant), so both packages only score them: no JAX solve is compiled
here; tests/test_torch_experiments.py runs the port's grid itself."""

import json
import os
import shutil
import struct

import numpy as np
import pytest
import torch
from PIL import Image as PILImage
from scipy.io import savemat

from acmmp_tpu import cli as jcli
from acmmp_tpu.io import colmap as jcolmap
from acmmp_tpu_torch import cli as tcli
from acmmp_tpu_torch.experiments.dtu_analysis import DTU_CAM_SETS
from acmmp_tpu_torch.io import colmap as tcolmap
from acmmp_tpu_torch.io import write_ply
from acmmp_tpu_torch.io.dense_folder import read_cam_txt
from acmmp_tpu_torch.utils.synth import (relief_gt_points,
                                         textured_plane_scene)

from .test_torch_experiments import assert_same_tree

torch.set_num_threads(1)

# COLMAP's binary camera model ids (colmap.github.io/format.html)
PINHOLE, SIMPLE_RADIAL = 1, 2


def _model(n_views=4, n_pts=80, seed=0):
    """The plane scene's views, PINHOLE and SIMPLE_RADIAL cameras, and
    sparse points on the plane, each seen by a seeded subset of views."""
    images, cams, plane_z = textured_plane_scene(n_views=n_views, width=48,
                                                 height=36)
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-1.5, 1.5, n_pts),
                    rng.uniform(-1.0, 1.0, n_pts),
                    plane_z + rng.uniform(-0.3, 0.3, n_pts)], axis=1)
    seen = rng.random((n_views, n_pts)) < 0.8
    return images, cams, pts, seen


def _qvec(cam):
    return jcolmap.rotmat2qvec(cam.R.astype(np.float64))


def _write_images(root, images):
    imdir = os.path.join(root, "images")
    os.makedirs(imdir, exist_ok=True)
    for i, img in enumerate(images):
        PILImage.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            os.path.join(imdir, _name(i)))


def _name(i):
    return f"im{i}.jpg" if i % 2 else f"im{i}.png"


def write_model_text(root, images, cams, pts, seen):
    sparse = os.path.join(root, "sparse")
    os.makedirs(sparse, exist_ok=True)
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        f.write("# camera list\n")
        for i, cam in enumerate(cams):
            if i % 2:
                f.write(f"{i + 1} SIMPLE_RADIAL {cam.width} {cam.height} "
                        f"{cam.K[0, 0]} {cam.K[0, 2]} {cam.K[1, 2]} 0.01\n")
            else:
                f.write(f"{i + 1} PINHOLE {cam.width} {cam.height} "
                        f"{cam.K[0, 0]} {cam.K[1, 1]} {cam.K[0, 2]} "
                        f"{cam.K[1, 2]}\n")
    with open(os.path.join(sparse, "images.txt"), "w") as f:
        for i, cam in enumerate(cams):
            q, t = _qvec(cam), cam.t
            f.write(f"{i + 1} {q[0]} {q[1]} {q[2]} {q[3]} "
                    f"{t[0]} {t[1]} {t[2]} {i + 1} {_name(i)}\n")
            ids = [k + 1 if seen[i, k] else -1 for k in range(len(pts))]
            f.write(" ".join(f"{k * 0.5} {k * 0.25} {pid}"
                             for k, pid in enumerate(ids)) + "\n")
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        for k, p in enumerate(pts):
            track = " ".join(f"{i + 1} {k}" for i in range(len(cams))
                             if seen[i, k])
            f.write(f"{k + 1} {p[0]} {p[1]} {p[2]} 128 128 128 0.5 "
                    f"{track}\n")


def write_model_binary(root, images, cams, pts, seen):
    sparse = os.path.join(root, "sparse")
    os.makedirs(sparse, exist_ok=True)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for i, cam in enumerate(cams):
            K = cam.K.astype(np.float64)
            if i % 2:
                params = (K[0, 0], K[0, 2], K[1, 2], 0.01)
                model = SIMPLE_RADIAL
            else:
                params = (K[0, 0], K[1, 1], K[0, 2], K[1, 2])
                model = PINHOLE
            f.write(struct.pack("<iiQQ", i + 1, model, cam.width,
                                cam.height))
            f.write(struct.pack("<4d", *params))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for i, cam in enumerate(cams):
            q, t = _qvec(cam), cam.t.astype(np.float64)
            f.write(struct.pack("<idddddddi", i + 1, *q, *t, i + 1))
            f.write(_name(i).encode() + b"\x00")
            f.write(struct.pack("<Q", len(pts)))
            for k in range(len(pts)):
                f.write(struct.pack("<ddq", k * 0.5, k * 0.25,
                                    k + 1 if seen[i, k] else -1))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for k, p in enumerate(pts):
            track = [i + 1 for i in range(len(cams)) if seen[i, k]]
            f.write(struct.pack("<QdddBBBd", k + 1, *p, 128, 128, 128, 0.5))
            f.write(struct.pack("<Q", len(track)))
            for i in track:
                f.write(struct.pack("<ii", i, k))


@pytest.fixture(params=[".txt", ".bin"])
def colmap_root(request, tmp_path):
    images, cams, pts, seen = _model()
    root = str(tmp_path / "colmap")
    _write_images(root, images)
    writer = write_model_text if request.param == ".txt" \
        else write_model_binary
    writer(root, images, cams, pts, seen)
    return root, request.param


def test_read_model_matches_jax(colmap_root):
    root, ext = colmap_root
    t = tcolmap.read_model(os.path.join(root, "sparse"), ext)
    j = jcolmap.read_model(os.path.join(root, "sparse"), ext)
    for td, jd in zip(t, j):
        assert sorted(td) == sorted(jd)
        for k in td:
            for field in vars(td[k]):
                a, b = getattr(td[k], field), getattr(jd[k], field)
                if isinstance(a, np.ndarray):
                    np.testing.assert_array_equal(a, b)
                else:
                    assert a == b
    cams, images, points = t
    ext_ = {}
    for iid, im in images.items():
        e = np.eye(4)
        e[:3, :3] = tcolmap.qvec2rotmat(im.qvec)
        e[:3, 3] = im.tvec
        ext_[iid] = e
    got = tcolmap.view_selection_scores(images, points, ext_)
    np.testing.assert_array_equal(
        got, jcolmap.view_selection_scores(images, points, ext_))
    assert (got > 0).sum() > 0
    for c in cams.values():
        np.testing.assert_array_equal(c.intrinsics(),
                                      jcolmap.ColmapCamera(**vars(c))
                                      .intrinsics())


@pytest.mark.parametrize("max_d", [192, 0])
def test_convert_colmap_matches_jax(colmap_root, tmp_path, max_d):
    root, ext = colmap_root
    t, j = str(tmp_path / "t"), str(tmp_path / "j")
    tcolmap.convert_colmap(root, t, max_d=max_d, interval_scale=1.5,
                           model_ext=ext)
    jcolmap.convert_colmap(root, j, max_d=max_d, interval_scale=1.5,
                           model_ext=ext)
    assert_same_tree(t, j)
    assert len(os.listdir(os.path.join(t, "cams"))) == 4


def test_cli_convert_colmap(colmap_root, tmp_path, capsys):
    root, ext = colmap_root
    outs = {}
    for name, cli in (("t", tcli), ("j", jcli)):
        outs[name] = str(tmp_path / name)
        assert cli.main(["convert-colmap", "--dense_folder", root,
                         "--save_folder", outs[name], "--max_d", "0",
                         "--model_ext", ext]) == 0
    assert_same_tree(outs["t"], outs["j"])


def _run_both(argv_of, capsys):
    """stdout of both packages' cli.main on argv_of('t') and argv_of('j')."""
    capsys.readouterr()
    out = {}
    for name, cli in (("t", tcli), ("j", jcli)):
        assert cli.main(argv_of(name)) == 0
        out[name] = capsys.readouterr().out
    return out


def _clouds(tmp_path):
    rng = np.random.default_rng(1)
    gt = np.c_[rng.uniform(0, 30, (4000, 2)), rng.uniform(0, 2, 4000)]
    rec = gt[:3000] + rng.normal(0, 0.5, (3000, 3))
    paths = []
    for name, pts in (("rec", rec), ("gt", gt)):
        paths.append(str(tmp_path / f"{name}.ply"))
        write_ply(paths[-1], pts.astype(np.float32),
                  np.zeros((len(pts), 3), np.float32),
                  np.zeros((len(pts), 3), np.uint8))
    return paths


@pytest.mark.parametrize("extra", [["--json"], [],
                                   ["--json", "--sampleset", "SS",
                                    "--scan", "3", "--dst", "0.5"]])
def test_cli_eval_dtu(tmp_path, capsys, extra):
    rec, gt = _clouds(tmp_path)
    if "--sampleset" in extra:
        os.makedirs(tmp_path / "ObsMask")
        mask = (np.random.default_rng(2).random((7, 7, 3)) < 0.7)
        savemat(str(tmp_path / "ObsMask" / "ObsMask3_10.mat"),
                {"ObsMask": mask.astype(np.uint8),
                 "BB": np.array([[-1.0, -1.0, -1.0], [34.0, 34.0, 14.0]]),
                 "Res": 5.0})
        savemat(str(tmp_path / "ObsMask" / "Plane3.mat"),
                {"P": np.array([0.0, 0.0, 1.0, -0.5])})
        extra = [str(tmp_path) if a == "SS" else a for a in extra]
    out = _run_both(lambda _: ["eval-dtu", rec, "--gt", gt] + extra, capsys)
    assert out["t"] == out["j"]
    if "--json" in extra:
        assert json.loads(out["t"]) == json.loads(out["j"])
        assert len(json.loads(out["t"])) == 12


def test_cli_select_cams(tmp_path, capsys):
    src = str(tmp_path / "src")
    assert tcli.main(["make-synthetic", src, "--n_views", "7", "--width",
                      "32", "--height", "24"]) == 0
    out = _run_both(lambda n: ["select-cams", src, str(tmp_path / n),
                               "--cams", "5,1,3,0", "--min_angle", "0",
                               "--max_n_view", "2", "--seed", "4"], capsys)
    assert out["t"].replace("/t\n", "/j\n") == out["j"]
    assert_same_tree(str(tmp_path / "t"), str(tmp_path / "j"))


@pytest.mark.parametrize("flags", [[], ["--relief", "--random_priors",
                                        "--n_views", "3", "--plane_z",
                                        "4.5"]])
def test_cli_make_synthetic(tmp_path, capsys, flags):
    _run_both(lambda n: ["make-synthetic", str(tmp_path / n), "--width",
                         "40", "--height", "30"] + flags, capsys)
    assert_same_tree(str(tmp_path / "t"), str(tmp_path / "j"),
                     png_decoded=("priors/depths", "priors/normals"))


def test_cli_make_priors(tmp_path, capsys):
    src = str(tmp_path / "src")
    assert tcli.main(["make-synthetic", src, "--n_views", "3",
                      "--relief"]) == 0
    cams = [read_cam_txt(os.path.join(src, "cams", f"{i:08d}_cam.txt"))
            for i in range(3)]
    pts = relief_gt_points(cams, 64, 48, samples=(48, 64))
    ply = str(tmp_path / "cloud.ply")
    write_ply(ply, pts.astype(np.float32), np.zeros_like(pts, np.float32),
              np.zeros(pts.shape, np.uint8))
    for n in ("t", "j"):
        shutil.copytree(src, str(tmp_path / n))
    out = _run_both(lambda n: ["make-priors", str(tmp_path / n), "--ply",
                               ply], capsys)
    assert out["t"].replace("/t/", "/j/") == out["j"]
    assert_same_tree(str(tmp_path / "t"), str(tmp_path / "j"),
                     png_decoded=("priors/normals",))
    assert len(os.listdir(tmp_path / "t" / "priors" / "depths")) == 3


def test_cli_display_cams(tmp_path, capsys):
    src = str(tmp_path / "src")
    assert tcli.main(["make-synthetic", src, "--n_views", "3"]) == 0
    rec, _ = _clouds(tmp_path)
    out = _run_both(lambda n: ["display-cams", src, "--out",
                               str(tmp_path / f"{n}.png"), "--ply", rec],
                    capsys)
    assert out["t"] == str(tmp_path / "t.png") + "\n"
    assert os.path.getsize(tmp_path / "t.png") > 1000
    with open(tmp_path / "t.png", "rb") as a, \
            open(tmp_path / "j.png", "rb") as b:
        assert a.read() == b.read()


def test_cli_analyze_dtu_scores_existing_variants(tmp_path, capsys):
    """Two scans, camera counts 2 and 3: select-cams builds each subset,
    the five variant PLYs are put in place, and both packages' analyze-dtu
    score them against the GT root, print the same paired tests and write
    the plots."""
    scans, gt_root = tmp_path / "scans", tmp_path / "gt"
    os.makedirs(gt_root)
    rng = np.random.default_rng(3)
    variants = ("ACMMP_no_prior.ply", "ACMMP_x2.ply", "acmmp_boost_1.ply",
                "acmmp_boost_single.ply", "ACMMP_full_prior.ply")
    for s, scan in enumerate(("scan1", "scan4")):
        src = str(scans / scan)
        assert tcli.main(["make-synthetic", src, "--n_views", "49",
                          "--width", "16", "--height", "12"]) == 0
        gt = np.c_[rng.uniform(0, 10, (800, 2)), np.full(800, 5.0)]
        write_ply(str(gt_root / f"{scan}.ply"), gt.astype(np.float32),
                  np.zeros((800, 3), np.float32), np.zeros((800, 3),
                                                           np.uint8))
        for n_cam in (2, 3):
            clouds = [gt[rng.choice(800, 300)] + rng.normal(
                0, 0.05 * (1 + v + s + n_cam), (300, 3))
                for v in range(len(variants))]
            for out_root in ("t", "j"):
                dense = str(tmp_path / out_root / f"{scan}_{n_cam}_cam")
                assert tcli.main(["select-cams", src, dense, "--cams",
                                  ",".join(map(str, DTU_CAM_SETS[n_cam]))]
                                 ) == 0
                for ply, pts in zip(variants, clouds):
                    write_ply(os.path.join(dense, ply),
                              pts.astype(np.float32),
                              np.zeros((300, 3), np.float32),
                              np.zeros((300, 3), np.uint8))
    out = _run_both(lambda n: ["analyze-dtu", str(scans), str(tmp_path / n),
                               "--cam_counts", "2,3", "--gt_root",
                               str(gt_root), "--plot_dir",
                               str(tmp_path / f"plots_{n}")]
                    + (["--device", "cpu"] if n == "t" else []), capsys)
    assert out["t"].replace("plots_t", "plots_j") == out["j"]
    assert out["t"].count(" vs ") == 2 * 10      # 5 methods, 2 metrics
    for name in ("acc_median.png", "completeness_median.png"):
        assert os.path.getsize(tmp_path / "plots_t" / name) > 1000
    assert_same_tree(str(tmp_path / "t"), str(tmp_path / "j"))


@pytest.mark.parametrize("cmd", ["reconstruct", "fuse"])
def test_only_solving_subcommands_need_a_dense_folder(tmp_path, capsys, cmd):
    """reconstruct and fuse reject a folder without pair.txt before any
    work; the other subcommands take other inputs and do not ask."""
    empty = tmp_path / "empty"
    os.makedirs(empty)
    for cli in (tcli, jcli):
        with pytest.raises(SystemExit) as e:
            cli.main([cmd, str(empty)])
        assert e.value.code == 2
        assert "not a dense folder" in capsys.readouterr().err
    # a subcommand whose first argument is a new folder runs
    assert tcli.main(["make-synthetic", str(tmp_path / "new"), "--width",
                      "16", "--height", "12", "--n_views", "2"]) == 0
