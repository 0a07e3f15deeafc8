"""DTU-style accuracy/completeness evaluation, MATLAB-free — the port's
copy of ``acmmp_tpu/eval/dtu.py`` (host numpy and scipy's cKDTree).

Replaces the reference's dependency on the official DTU MATLAB evaluation
(python_scripts/matlab_analysis.py:35-103 shells into
run_matlab_analysis): the same protocol shape — down-sample the
reconstruction to a minimum point spacing `dst` (the official reducePts with
dst=0.2), then measure nearest-neighbor distances reconstruction->GT
(accuracy) and GT->reconstruction (completeness), capping outliers at
`max_dist` — producing the 12-metric vector the reference's tooling consumes
(visualise_dtu_metrics_2.py:33): acc@{0.5,2,5,10}mm, cmp@{0.5,2,5,10}mm,
acc mean/median, completeness mean/median.

Without the official ObsMask/margin files this is an unmasked variant;
pass `gt_mask_fn` to restrict accuracy to observed regions when those
files are available.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

METRIC_NAMES = (
    "acc05", "acc2", "acc5", "acc10",
    "cmp05", "cmp2", "cmp5", "cmp10",
    "acc_mean", "acc_median", "completeness_mean", "completeness_median",
)


def reduce_points(pts: np.ndarray, dst: float) -> np.ndarray:
    """Down-sample so no two kept points are closer than `dst`.

    Two passes: (1) greedy grid hash keeping the first point per
    dst-sized cell, then (2) a cross-cell pass that enforces the official
    reducePts min-spacing invariant — lexicographic greedy over the
    survivors, dropping any point within `dst` of an earlier-kept one
    (without this pass, first-per-cell survivors in ADJACENT cells can
    sit arbitrarily close across the boundary). The kept set is
    guaranteed pairwise >= dst apart, like the official MATLAB reducePts
    (which removes all points within dst of each kept point); the grid
    pre-pass makes the selection deterministic-by-point-order rather
    than randomized, and can keep slightly fewer same-cell points than
    the official greedy (two points in one dst-cell can be up to
    sqrt(3)*dst apart) — self-comparisons are exact, absolute densities
    are within the official protocol's own permutation variance."""
    if len(pts) == 0 or dst <= 0:
        return pts
    cell = np.floor(pts / dst).astype(np.int64)
    # pass 1: keep first point per cell
    _, keep_idx = np.unique(cell, axis=0, return_index=True)
    out = pts[np.sort(keep_idx)]
    # pass 2: reject cross-cell neighbors closer than dst (greedy in point
    # order; processing pairs by ascending second index means each point's
    # own fate is final before it can eliminate a later one)
    from scipy.spatial import cKDTree

    pairs = cKDTree(out).query_pairs(dst, output_type="ndarray")
    if len(pairs):
        alive = np.ones(len(out), bool)
        order = np.argsort(pairs[:, 1], kind="stable")
        for i, j in pairs[order]:
            if alive[i]:
                alive[j] = False
        out = out[alive]
    return out


def nn_distances(a: np.ndarray, b: np.ndarray, workers: int = -1,
                 distance_upper_bound: float = np.inf) -> np.ndarray:
    """For each point in `a`, distance to nearest point of `b` (KD-tree);
    inf where none lies below `distance_upper_bound`."""
    from scipy.spatial import cKDTree

    if len(a) == 0:
        return np.zeros((0,), np.float64)
    if len(b) == 0:
        return np.full((len(a),), np.inf)
    tree = cKDTree(b)
    d, _ = tree.query(a, k=1, workers=workers,
                      distance_upper_bound=distance_upper_bound)
    return d


def dtu_metrics(recon: np.ndarray, gt: np.ndarray, dst: float = 0.2,
                max_dist: float = 60.0,
                gt_mask_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                cmp_mask_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                obs_mask=None,
                ) -> Dict[str, float]:
    """The 12-metric DTU vector for a reconstruction against GT points.

    `gt_mask_fn` restricts the accuracy side (reconstruction points kept
    where observable); `cmp_mask_fn` restricts the completeness side
    (ground-truth points that count). Passing `obs_mask`
    (eval.obsmask.DtuObsMask) sets both to the official protocol's masks."""
    if obs_mask is not None:
        gt_mask_fn = gt_mask_fn or obs_mask.accuracy_mask
        cmp_mask_fn = cmp_mask_fn or obs_mask.completeness_mask
    recon_full = reduce_points(np.asarray(recon, np.float64), dst)
    gt = np.asarray(gt, np.float64)
    # accuracy scores only observable recon points; completeness targets the
    # FULL reduced reconstruction (BaseEvalMain_web.m masks Ddata only)
    recon = recon_full
    if gt_mask_fn is not None and len(recon_full):
        recon = recon_full[gt_mask_fn(recon_full)]
    if cmp_mask_fn is not None and len(gt):
        gt = gt[cmp_mask_fn(gt)]

    # distances beyond max_dist are dropped (accuracy) or capped
    # (completeness), so the searches stop just above it: the same numbers
    # as unbounded searches, without a far outlier's walk through the
    # whole ground-truth tree
    bound = np.nextafter(max_dist, np.inf)
    d_acc = nn_distances(recon, gt, distance_upper_bound=bound)
    d_acc = d_acc[d_acc <= max_dist] if len(d_acc) else d_acc
    d_cmp = nn_distances(gt, recon_full, distance_upper_bound=bound)
    d_cmp = np.minimum(d_cmp, max_dist)

    def frac(d, t):
        return float((d < t).mean()) if len(d) else 0.0

    out = {
        "acc05": frac(d_acc, 0.5), "acc2": frac(d_acc, 2.0),
        "acc5": frac(d_acc, 5.0), "acc10": frac(d_acc, 10.0),
        "cmp05": frac(d_cmp, 0.5), "cmp2": frac(d_cmp, 2.0),
        "cmp5": frac(d_cmp, 5.0), "cmp10": frac(d_cmp, 10.0),
        "acc_mean": float(d_acc.mean()) if len(d_acc) else float("inf"),
        "acc_median": float(np.median(d_acc)) if len(d_acc) else float("inf"),
        "completeness_mean": float(d_cmp.mean()) if len(d_cmp) else float("inf"),
        "completeness_median": float(np.median(d_cmp)) if len(d_cmp) else float("inf"),
    }
    return out


def evaluate_ply(ply_path: str, gt_points: np.ndarray, dst: float = 0.2,
                 max_dist: float = 60.0, obs_mask=None) -> Dict[str, float]:
    from acmmp_tpu_torch.io import read_ply

    pts, _, _ = read_ply(ply_path)
    return dtu_metrics(pts, gt_points, dst=dst, max_dist=max_dist,
                       obs_mask=obs_mask)
