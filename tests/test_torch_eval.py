"""The port's evaluation (eval/dtu.py, eval/obsmask.py, eval/stats.py) and
its full-scale quality tool against the JAX package's on the CPU.

The evaluation is host numpy and scipy in both packages, so every bar is
equality: equal arrays, equal metric dicts, equal p-values. The tool runs
one small run_pipeline on the CPU; its 12 metrics must equal the JAX
package's dtu_metrics of the same PLY against the JAX package's ground
truth of the same rig."""

import json
import os

import numpy as np
import pytest
import torch
from scipy.io import savemat

from acmmp_tpu.eval import dtu as jdtu
from acmmp_tpu.eval import obsmask as jobs
from acmmp_tpu.eval import stats as jstats
from acmmp_tpu.io import write_ply as jwrite_ply
from acmmp_tpu.utils.synth import relief_gt_points as jrelief_gt_points
from acmmp_tpu.utils.synth import textured_relief_scene as jrelief_scene
from acmmp_tpu_torch.eval import dtu as tdtu
from acmmp_tpu_torch.eval import obsmask as tobs
from acmmp_tpu_torch.eval import stats as tstats
from acmmp_tpu_torch.tools import fullscale_quality, rand_window_ab

torch.set_num_threads(1)


def _clouds(seed=0, n_gt=3000, n_rec=2500):
    """A noisy partial reconstruction of a wavy GT surface, in mm."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 40, (n_gt, 2))
    gt = np.c_[xy, 5 * np.sin(xy[:, 0] / 7)]
    pick = rng.choice(n_gt, n_rec, replace=False)
    rec = gt[pick] + rng.normal(0, 0.8, (n_rec, 3))
    rec[:50] += rng.uniform(20, 80, (50, 3))       # outliers
    return rec, gt


def _obsmask_root(tmp_path, scan=7, plane=True):
    """A toy SampleSet (ObsMask<scan>_10.mat, Plane<scan>.mat) over
    _clouds' extent: a random observable voxel volume and a tilted table
    plane."""
    mdir = tmp_path / "ObsMask"
    os.makedirs(mdir, exist_ok=True)
    rng = np.random.default_rng(3)
    mask = (rng.random((10, 10, 6)) < 0.6).astype(np.uint8)
    bb = np.array([[-2.0, -2.0, -8.0], [48.0, 48.0, 22.0]])
    savemat(str(mdir / f"ObsMask{scan}_10.mat"),
            {"ObsMask": mask, "BB": bb, "Res": 5.0})
    if plane:
        savemat(str(mdir / f"Plane{scan}.mat"),
                {"P": np.array([0.05, 0.0, 1.0, 2.0])})
    return str(tmp_path)


@pytest.mark.parametrize("dst", [0.0, 0.5, 2.0])
def test_reduce_points_matches_jax(dst):
    rec, _ = _clouds()
    np.testing.assert_array_equal(tdtu.reduce_points(rec, dst),
                                  jdtu.reduce_points(rec, dst))


def test_nn_distances_matches_jax():
    rec, gt = _clouds(1)
    np.testing.assert_array_equal(tdtu.nn_distances(rec, gt),
                                  jdtu.nn_distances(rec, gt))
    for a, b in ((rec[:0], gt), (rec, gt[:0])):
        np.testing.assert_array_equal(tdtu.nn_distances(a, b),
                                      jdtu.nn_distances(a, b))


@pytest.mark.parametrize("masked", ["plain", "mask_fns", "obs_mask",
                                    "obs_mask_no_plane", "far_outliers"])
def test_dtu_metrics_match_jax(tmp_path, masked):
    """The port's searches stop just above max_dist; the metrics must equal
    the JAX package's unbounded ones, outliers far beyond max_dist and
    points at exactly max_dist included."""
    rec, gt = _clouds(2)
    kw_t, kw_j = {}, {}
    if masked == "far_outliers":
        rng = np.random.default_rng(9)
        # two points exactly max_dist from the isolated GT point
        rec = np.concatenate([rec, rng.normal(0, 500, (200, 3)),
                              [[520.0, 500.0, 0.0], [500.0, 500.0, 20.0]]])
        gt = np.concatenate([gt, [[500.0, 500.0, 0.0]]])
    if masked == "mask_fns":
        kw_t = kw_j = {"gt_mask_fn": lambda p: p[:, 0] < 30,
                       "cmp_mask_fn": lambda p: p[:, 2] > -2}
    elif masked.startswith("obs_mask"):
        root = _obsmask_root(tmp_path, plane=masked == "obs_mask")
        kw_t = {"obs_mask": tobs.DtuObsMask.load(root, 7)}
        kw_j = {"obs_mask": jobs.DtuObsMask.load(root, 7)}
    got = tdtu.dtu_metrics(rec, gt, dst=0.2, max_dist=20.0, **kw_t)
    want = jdtu.dtu_metrics(rec, gt, dst=0.2, max_dist=20.0, **kw_j)
    assert list(got) == list(tdtu.METRIC_NAMES) == list(jdtu.METRIC_NAMES)
    assert got == want
    assert tdtu.dtu_metrics(rec[:0], gt) == jdtu.dtu_metrics(rec[:0], gt)


def test_obsmask_matches_jax(tmp_path):
    root = _obsmask_root(tmp_path)
    t, j = tobs.DtuObsMask.load(root, 7), jobs.DtuObsMask.load(root, 7)
    np.testing.assert_array_equal(t.mask, j.mask)
    np.testing.assert_array_equal(t.bb, j.bb)
    np.testing.assert_array_equal(t.plane, j.plane)
    assert t.res == j.res
    rec, gt = _clouds(4)
    np.testing.assert_array_equal(t.accuracy_mask(rec), j.accuracy_mask(rec))
    np.testing.assert_array_equal(t.completeness_mask(gt),
                                  j.completeness_mask(gt))
    assert 0 < t.accuracy_mask(rec).sum() < len(rec)


def test_evaluate_ply_matches_jax(tmp_path):
    rec, gt = _clouds(5)
    ply = str(tmp_path / "rec.ply")
    jwrite_ply(ply, rec.astype(np.float32),
               np.zeros((len(rec), 3), np.float32),
               np.zeros((len(rec), 3), np.uint8))
    assert tdtu.evaluate_ply(ply, gt) == jdtu.evaluate_ply(ply, gt)


def test_holm_and_paired_tests_match_jax():
    rng = np.random.default_rng(6)
    p = rng.uniform(0, 0.2, 9)
    np.testing.assert_array_equal(tstats.holm_correction(p),
                                  jstats.holm_correction(p))
    tt, jt = tstats.MetricTable(), jstats.MetricTable()
    for method, shift in (("no_prior", 0.0), ("x2", 0.02), ("boost_1", 0.1)):
        for scan in ("scan1", "scan4", "scan9", "scan11"):
            for ncam in (3, 5):
                m = {k: float(rng.uniform(0, 1) + shift)
                     for k in tdtu.METRIC_NAMES}
                tt.add(method, scan, ncam, m)
                jt.add(method, scan, ncam, m)
    assert tt.methods() == jt.methods()
    np.testing.assert_array_equal(tt.matrix("x2", 3), jt.matrix("x2", 3))
    assert tt.paired_keys("x2", "boost_1") == jt.paired_keys("x2", "boost_1")
    for metric in ("acc_median", "completeness_median", "acc2"):
        for ncam in (None, 5):
            got = tstats.paired_tests(tt, metric, ncam)
            assert got == jstats.paired_tests(jt, metric, ncam)
            assert len(got) == 3


def test_fullscale_quality_tool_on_cpu(tmp_path, capsys):
    """The tool end to end at 96x64 / 3 views on the CPU: the JAX tool's
    keys, a cloud, and metrics equal to the JAX package's dtu_metrics of
    the same PLY against the JAX ground truth of the same rig."""
    out = str(tmp_path / "q.json")
    res = fullscale_quality.main([
        "--width", "96", "--height", "64", "--views", "3",
        "--device", "cpu", "--dense", str(tmp_path / "dense"),
        "--out", out])
    with open(out) as f:
        assert json.load(f) == res
    assert res["device"] == "cpu" and res["shape"] == "96x64"
    assert res["points"] > 1000
    _, cams, _ = jrelief_scene(n_views=3, width=96, height=64,
                               f=140.0, spread=1.2, converge=True)
    gt = jrelief_gt_points(cams, 96, 64)
    assert res["gt_points"] == len(gt)
    from acmmp_tpu.io import read_ply

    pts, _, _ = read_ply(res["ply"])
    want = jdtu.dtu_metrics(np.asarray(pts, np.float64) * 150.0, gt * 150.0,
                            dst=0.2)
    assert res["metrics"] == {k: round(float(v), 4) for k, v in want.items()}
    assert res["metrics"]["acc10"] > 0.5
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == res


def test_rand_window_ab_tool_on_cpu(tmp_path):
    """The A/B tool at 64x48 on the CPU: one record per (window, min_cos)
    with the JAX tool's keys plus `device`, appended to --json."""
    path = str(tmp_path / "ab.jsonl")
    recs = rand_window_ab.main([
        "--height", "48", "--width", "64", "--views", "2", "--seeds", "1",
        "--windows", "0", "--min_cos", "0,0.25", "--scene", "relief",
        "--device", "cpu", "--json", path])
    with open(path) as f:
        assert [json.loads(line) for line in f] == recs
    assert [(r["window"], r["min_cos"]) for r in recs] == [(0.0, 0.0),
                                                          (0.0, 0.25)]
    assert set(recs[0]) == {
        "scene", "rig", "h", "w", "views", "plane_z", "window", "min_cos",
        "median_err", "median_err_std", "inliers_0.1", "inliers_std",
        "ms_per_solve", "device"}
    assert all(r["device"] == "cpu" and r["median_err"] < 0.1
               for r in recs)
