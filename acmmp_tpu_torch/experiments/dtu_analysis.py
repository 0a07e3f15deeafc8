"""The DTU experiment grid: the method-variant matrix of the reference
harness — the port's copy of ``acmmp_tpu/experiments/dtu_analysis.py``.

Re-implements evaluate_dtu_structure.py:34-104 / run_dtu_analysis.py:48-90
without subprocesses or the private prior-sampler dependency — the pipeline
is a library call (the port's run_pipeline, on CUDA unless a `device` says
otherwise), priors are bootstrapped by experiments/prior_sampler.

Per (scan, camera subset), the full 5-method grid the reference's
statistics consume (dtu_statistics.py:14):
  1. plain reconstruction                       -> ACMMP_no_prior.ply
  2. dual-hypothesis refusion vs. itself        -> ACMMP_x2.ply
     (--output_dir ACMMP2 --multi_fusion ACMMP --force_fusion,
      evaluate_dtu_structure.py:49-57)
  3. priors rendered from (1)'s point cloud, seeded re-run with
     prior-aware fusion                         -> acmmp_boost_1.ply
     (run_dtu_analysis.py:60-90)
  4. same seeded re-run fused alone             -> acmmp_boost_single.ply
     (DTU_full_prior_analysis.py:48-85)
  5. priors rendered from the GT cloud          -> ACMMP_full_prior.ply
     (DTU_full_prior_analysis.py:88-133; needs per-scan GT points)

All outputs are idempotent: existing PLYs are not recomputed (the
reference's de-facto resume protocol, evaluate_dtu_structure.py:42-60)."""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Dict, List, Optional, Sequence

import numpy as np

from acmmp_tpu_torch.config import PipelineConfig
from acmmp_tpu_torch.eval.dtu import dtu_metrics
from acmmp_tpu_torch.eval.stats import MetricTable
from acmmp_tpu_torch.experiments.prior_sampler import write_priors_from_points
from acmmp_tpu_torch.experiments.select_cams import (ReconParams,
                                                     setup_from_source)
from acmmp_tpu_torch.io import read_ply
from acmmp_tpu_torch.io.dense_folder import load_cams
from acmmp_tpu_torch.pipeline.scheduler import run_pipeline
from acmmp_tpu_torch.utils.log import get_logger

log = get_logger("dtu_analysis")

# the reference's camera subsets per count (run_dtu_analysis.py:27-38)
DTU_CAM_SETS: Dict[int, List[int]] = {
    2: [38, 48],
    3: [38, 8, 48],
    4: [38, 8, 48, 43],
    5: [13, 17, 38, 43, 48],
    6: [8, 22, 26, 38, 43, 48],
    7: [0, 4, 25, 21, 38, 43, 48],
    8: [0, 4, 8, 21, 26, 38, 43, 48],
    9: [0, 4, 19, 23, 27, 38, 42, 45, 48],
    10: [0, 4, 19, 22, 25, 27, 38, 42, 45, 48],
}


def _cfg(base: PipelineConfig, **kw) -> PipelineConfig:
    return dataclasses.replace(base, **kw)


def analyze_scene(
    dense_folder: str,
    base_cfg: Optional[PipelineConfig] = None,
    boost: bool = True,
    gt_points: Optional[np.ndarray] = None,
    device=None,
) -> Dict[str, str]:
    """Run the 5-method variant grid on one dense folder on `device` (CUDA
    unless told otherwise); returns variant -> PLY path for every variant
    that succeeded (failures are logged and skipped so earlier variants
    still get scored). Idempotent per variant.

    Variants (the reference's statistical grid, dtu_statistics.py:14):
      no_prior     - plain reconstruction        (evaluate_dtu_structure.py:42)
      x2           - dual-hypothesis refusion    (evaluate_dtu_structure.py:49-57)
      boost_1      - self-prior seeded re-run, prior-aware fusion
                                                 (run_dtu_analysis.py:60-90)
      boost_single - same seeded re-run, fused alone (no multi-fusion)
                                                 (DTU_full_prior_analysis.py:48-85)
      full_prior   - priors rendered from the GT cloud (needs `gt_points`)
                                                 (DTU_full_prior_analysis.py:88-133)
    """
    cfg = base_cfg or PipelineConfig()
    out: Dict[str, str] = {}

    def variant(name: str, ply_name: str, fn) -> None:
        path = os.path.join(dense_folder, ply_name)
        try:
            if not os.path.exists(path):
                shutil.copy(fn(), path)
            out[name] = path
        except Exception:
            log.exception("variant %s failed on %s; continuing", name,
                          dense_folder)

    variant("no_prior", "ACMMP_no_prior.ply",
            lambda: run_pipeline(dense_folder, cfg, device=device))
    variant("x2", "ACMMP_x2.ply",
            lambda: run_pipeline(dense_folder, _cfg(
                cfg, output_dir="ACMMP2", fusion_dir="ACMMP",
                multi_fusion=True, force_fusion=True), device=device))

    if boost and "no_prior" in out:
        def _self_priors():
            pts, _, _ = read_ply(out["no_prior"])
            write_priors_from_points(dense_folder, pts, load_cams(dense_folder))

        def _boost1():
            _self_priors()
            return run_pipeline(dense_folder, _cfg(
                cfg, output_dir="ACMMP_BOOST", fusion_dir="ACMMP",
                use_prior=True, multi_fusion=True), device=device)

        def _boost_single():
            # seeded from the same self-priors, but fused on its own
            # (DTU_full_prior_analysis.py:78-84 runs plain `-p`)
            _self_priors()
            return run_pipeline(dense_folder, _cfg(
                cfg, output_dir="ACMMP_BOOST_SINGLE", use_prior=True,
                multi_fusion=False), device=device)

        variant("boost_1", "acmmp_boost_1.ply", _boost1)
        variant("boost_single", "acmmp_boost_single.ply", _boost_single)

    if gt_points is not None:
        def _full_prior():
            # priors rendered from the (downsampled) ground-truth cloud
            # (DTU_full_prior_analysis.py:95-101 subsamples 1/100)
            pts = np.asarray(gt_points)
            if len(pts) > 100:
                idx = np.random.default_rng(0).choice(
                    len(pts), len(pts) // 100, replace=False)
                pts = pts[idx]
            write_priors_from_points(dense_folder, pts, load_cams(dense_folder))
            return run_pipeline(dense_folder, _cfg(
                cfg, output_dir="ACMMP_full_prior", use_prior=True,
                multi_fusion=False), device=device)

        variant("full_prior", "ACMMP_full_prior.ply", _full_prior)
    return out


def analyze_dtu_scans(
    scans_root: str,
    out_root: str,
    cam_counts: Sequence[int] = (2, 3, 5, 9),
    params: Optional[ReconParams] = None,
    base_cfg: Optional[PipelineConfig] = None,
    gt_points: Optional[Dict[str, np.ndarray]] = None,
    device=None,
) -> MetricTable:
    """The full experiment grid: scans x camera subsets x method variants
    (run_dtu_analysis.py main loop), every pipeline on `device` (CUDA
    unless told otherwise). `gt_points` maps scan name -> GT point array;
    when given, every PLY is scored and collected into a MetricTable for
    eval.stats.paired_tests."""
    params = params or ReconParams(mindist=300, maxdist=800, maxangle=120)
    table = MetricTable()
    scans = sorted(d for d in os.listdir(scans_root)
                   if os.path.isdir(os.path.join(scans_root, d)))
    for scan in scans:
        src = os.path.join(scans_root, scan)
        for n_cam in cam_counts:
            cams = DTU_CAM_SETS[n_cam]
            dense = os.path.join(out_root, f"{scan}_{n_cam}_cam")
            if not os.path.exists(os.path.join(dense, "pair.txt")):
                setup_from_source(cams, src, dense, params)
            gp = gt_points.get(scan) if gt_points else None
            try:
                plys = analyze_scene(dense, base_cfg, gt_points=gp,
                                     device=device)
            except Exception:
                log.exception("scan %s n_cam %d failed; continuing", scan,
                              n_cam)
                continue
            if gt_points and scan in gt_points:
                for method, ply in plys.items():
                    pts, _, _ = read_ply(ply)
                    table.add(method, scan, n_cam,
                              dtu_metrics(pts, gt_points[scan]))
    return table
