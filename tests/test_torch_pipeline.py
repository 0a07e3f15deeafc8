"""The scheduler and CLI of acmmp_tpu_torch on a synthetic dense folder
(CPU), against the bars of tests/test_pipeline.py and against acmmp_tpu.

One run of the port's `run_pipeline` on a 4-view 64x48 textured-plane
dense folder with patch_size=7 and size_bound=32, so that the schedule has
two scales (32x24, then JBU to 64x48 and the hierarchy pass): 32 solves
(each view's first solve, its planar-prior second solve where the
triangulation gives a prior, and two geometric solves, per scale). The
tests then check its disk layout and fused cloud, its resume, one
geometric pass (the JAX package's `process_problem`, the port's
`process_batch` of one view) on copies of its checkpoints (the bar of
tests/test_torch_geom_solve.py: 97% of interior depths within 1%), and
the CLI, whose `reconstruct --view_batch 2` runs the batched executor."""

import dataclasses
import glob
import os
import shutil

import numpy as np
import pytest
import torch

from acmmp_tpu.config import FusionParams as JaxFusionParams
from acmmp_tpu.config import PatchMatchParams as JaxParams
from acmmp_tpu.config import PipelineConfig as JaxPipelineConfig
from acmmp_tpu.engine.fusion import run_fusion as jax_run_fusion
from acmmp_tpu.pipeline import scheduler as jsched
from acmmp_tpu_torch.cli import main
from acmmp_tpu_torch.config import (FusionParams, PatchMatchParams,
                                    PipelineConfig)
from acmmp_tpu_torch.io import read_dmb, read_ply
from acmmp_tpu_torch.pipeline import scheduler as tsched
from acmmp_tpu_torch.pipeline.batched import BatchedSolver
from acmmp_tpu_torch.utils.synth import (textured_plane_scene,
                                         write_dense_folder)

torch.set_num_threads(1)

N_VIEWS, W, H = 4, 64, 48
SIZE_BOUND = 32
CFG = PipelineConfig(
    patchmatch=PatchMatchParams(patch_size=7, size_bound=SIZE_BOUND),
    fusion=FusionParams(num_consistent_thresh=2),
    pad_h=1, pad_w=1, debug_images=True)
INTERIOR = np.s_[10:38, 12:52]
# one geometric pass of the two packages from the same checkpoints
# (tests/test_torch_geom_solve.py pins the same shares for a geometric
# solve from the same inputs)
SHARE_WITHIN_1PCT = 0.97


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    images, cams, plane_z = textured_plane_scene(n_views=N_VIEWS, width=W,
                                                 height=H)
    dense = write_dense_folder(str(tmp_path_factory.mktemp("pipe") / "s"),
                               images, cams)
    ply = tsched.run_pipeline(dense, CFG, device="cpu")
    return dense, ply, plane_z


def test_pipeline_layout_and_cloud(run):
    """The bars of test_full_pipeline_synthetic and the reference layout,
    at two scales."""
    dense, ply, plane_z = run
    out = os.path.join(dense, "ACMMP")
    assert ply == os.path.join(out, "ACMMP_model.ply")
    for i in range(N_VIEWS):
        rdir = os.path.join(out, f"2333_{i:08d}")
        for name, shape in (("depths.dmb", (H, W)),
                            ("depths_geom.dmb", (H, W)),
                            ("costs.dmb", (H, W)),
                            ("normals.dmb", (H, W, 3))):
            assert read_dmb(os.path.join(rdir, name)).shape == shape
        assert os.path.exists(os.path.join(rdir, "triangulation.png"))
    # 2 scales x (first solve + 2 geometric passes) x 4 views
    markers = glob.glob(os.path.join(out, "2333_*", ".pass_*.json"))
    assert len(markers) == 24, markers
    assert os.path.exists(os.path.join(out, "approved_pixels_cam_0.png"))
    pts, normals, colors = read_ply(ply)
    assert len(pts) > 100, len(pts)
    err = np.abs(pts[:, 2] - plane_z)
    assert np.median(err) < 0.1, np.median(err)
    assert (err < 0.5).mean() > 0.9


def test_fusion_of_the_checkpoints_matches_jax_and_cli(run, tmp_path):
    """The JAX package's fusion of the port's checkpoints writes the same
    PLY bytes, and so does the port's `fuse` subcommand."""
    with open(run[1], "rb") as f:
        want = f.read()
    dense = str(tmp_path / "s")
    shutil.copytree(run[0], dense)
    out = os.path.join(dense, "ACMMP")
    os.remove(os.path.join(out, "ACMMP_model.ply"))
    jply = jax_run_fusion(dense, out, jsched.generate_sample_list(dense),
                          geom_consistency=True,
                          fp=JaxFusionParams(num_consistent_thresh=2),
                          ply_name="jax.ply")
    assert main(["fuse", dense, "--geom", "--device", "cpu",
                 "--num_consistent_thresh", "2"]) == 0
    with open(jply, "rb") as f:
        assert f.read() == want
    with open(os.path.join(out, "ACMMP_model.ply"), "rb") as f:
        assert f.read() == want


def test_pipeline_resume(run, tmp_path):
    """resume=True rewrites nothing; removing one marker re-runs exactly
    that solve (tests/test_pipeline.py::test_pipeline_stage_resume)."""
    dense = str(tmp_path / "s")
    shutil.copytree(run[0], dense)
    out = os.path.join(dense, "ACMMP")

    def mtimes():
        return {p: os.stat(p).st_mtime_ns for p in glob.glob(
            os.path.join(out, "2333_*", "*.dmb"))}

    before = mtimes()
    cfg_r = dataclasses.replace(CFG, resume=True)
    assert os.path.exists(tsched.run_pipeline(dense, cfg_r, device="cpu"))
    assert mtimes() == before, "resume must not recompute completed solves"

    victim = os.path.join(out, "2333_00000001")
    tags = sorted(glob.glob(os.path.join(victim, ".pass_*.json")))
    assert len(tags) == 6
    os.remove(tags[-1])
    tsched.run_pipeline(dense, cfg_r, device="cpu")
    after = mtimes()
    changed = {p for p in before if after[p] != before[p]}
    assert changed == {os.path.join(victim, f)
                       for f in ("depths_geom.dmb", "normals.dmb",
                                 "costs.dmb")}, changed
    assert os.path.exists(tags[-1])


def test_geometric_pass_agrees_with_jax(run, tmp_path):
    """View 0's last geometric pass (multi_geometry, pass 5) through the
    JAX package's process_problem and the port's process_batch of that
    one view, from copies of the same checkpoints, with the same key."""
    results = {}
    for name, sched, cfg in (
            ("jax", jsched, JaxPipelineConfig(
                patchmatch=JaxParams(patch_size=7, size_bound=SIZE_BOUND,
                                     ncc_backend="jnp"),
                pad_h=1, pad_w=1)),
            ("port", tsched, dataclasses.replace(CFG, debug_images=False))):
        dense = str(tmp_path / name)
        shutil.copytree(run[0], dense)
        problems = sched.generate_sample_list(dense)
        sched.compute_multiscale_settings(dense, problems, cfg.patchmatch)
        for p in problems:
            p.cur_image_size = p.max_image_size
        common = dict(geom_consistency=True, planar_prior=False,
                      hierarchy=False, multi_geometry=True, pass_tag=5)
        out = os.path.join(dense, "ACMMP")
        if name == "port":
            sched.process_batch(
                dense, out, problems, [0], cfg, sched.ViewLoader(dense),
                BatchedSolver(cfg.patchmatch), device="cpu", **common)
        else:
            sched.process_problem(dense, out, problems, 0, cfg,
                                  sched.ViewLoader(dense), **common)
        results[name] = read_dmb(os.path.join(
            dense, "ACMMP", "2333_00000000", "depths_geom.dmb"))
    port, ref = results["port"], results["jax"]
    assert np.isfinite(port).all()
    rel = np.abs(port[INTERIOR] - ref[INTERIOR]) / np.abs(ref[INTERIOR])
    share = (rel < 0.01).mean()
    print(f"within 1%: {share:.4f}, within 5%: {(rel < 0.05).mean():.4f}")
    assert share >= SHARE_WITHIN_1PCT, share


def test_cli_friendly_errors(tmp_path, run, monkeypatch):
    """A missing or non-dense folder exits 2 (tests/test_pipeline.py::
    test_cli_friendly_error_on_missing_folder); --mesh asks for the
    visible CUDA devices and raises without one (no quiet CPU mesh);
    `reconstruct --view_batch 2` runs the batched executor on
    the file's 64x48 folder (the CLI's default params: one scale), its
    cloud meets the bars of test_pipeline_layout_and_cloud, and the JAX
    package's fusion of its checkpoints writes its PLY bytes."""
    for cmd in ("reconstruct", "fuse"):
        with pytest.raises(SystemExit) as e:
            main([cmd, str(tmp_path / "nope")])
        assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        main(["reconstruct", str(tmp_path)])
    assert e.value.code == 2
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["reconstruct", run[0], "--mesh"])
    dense = str(tmp_path / "s")
    shutil.copytree(run[0], dense, ignore=shutil.ignore_patterns("ACMMP"))
    assert main(["reconstruct", dense, "--view_batch", "2", "--device",
                 "cpu", "--num_consistent_thresh", "2"]) == 0
    out = os.path.join(dense, "ACMMP")
    markers = glob.glob(os.path.join(out, "2333_*", ".pass_*.json"))
    assert len(markers) == 3 * N_VIEWS, markers
    ply = os.path.join(out, "ACMMP_model.ply")
    pts, _, _ = read_ply(ply)
    assert len(pts) > 100, len(pts)
    err = np.abs(pts[:, 2] - run[2])
    assert np.median(err) < 0.1, np.median(err)
    assert (err < 0.5).mean() > 0.9
    jply = jax_run_fusion(dense, out, jsched.generate_sample_list(dense),
                          geom_consistency=True,
                          fp=JaxFusionParams(num_consistent_thresh=2),
                          ply_name="jax.ply")
    with open(jply, "rb") as f, open(ply, "rb") as g:
        assert f.read() == g.read()
