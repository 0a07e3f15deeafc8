"""The numbers by which a cell's output is held to the plain reference.

Every number is a gap: 0 when the two sides agree, larger the more they
differ. PatchMatch is chaotic (a cost that moves by rounding can flip a
pixel's choice, and propagation carries the flip to its neighbours), so
a sound program does not reproduce the reference bit for bit: the
numbers are shares and quantiles over the pixels, whose sound readings
and whose readings under the control and under planted faults are in
PERF.md with the limits set from them."""

from __future__ import annotations

import numpy as np


NUMBERS = ("depth_off_share", "cost_gap_p50", "depth_rel_p50",
           "depth_rel_p90", "depth_same_share", "cost_gap_p90",
           "cost_gap_mean", "normal_off_share")


def solve_gaps(depth, normal, cost, ref_depth, ref_normal,
               ref_cost) -> dict:
    """Gaps of one view's maps (depth [H, W], world normal [H, W, 3],
    cost [H, W], true extent) to the reference's.

    cost_gap_p50, cost_gap_p90: the median and the 90th-percentile
    pixel's |cost - reference cost|.
    depth_rel_p50, depth_rel_p90: the same of |depth - reference depth|
    over the reference depth (not finite: infinite).
    A cell's mix names the numbers it compares; the rest are printed
    beside them."""
    depth = np.asarray(depth, np.float64)
    ref_depth = np.asarray(ref_depth, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(depth - ref_depth) / np.abs(ref_depth)
    rel = np.where(np.isfinite(rel), rel, np.inf)
    cgap = np.abs(np.asarray(cost, np.float64)
                  - np.asarray(ref_cost, np.float64))
    cgap = np.where(np.isfinite(cgap), cgap, np.inf)
    cos = np.sum(np.asarray(normal, np.float64)
                 * np.asarray(ref_normal, np.float64), -1)
    cos = np.where(np.isfinite(cos), cos, -1.0)
    return {
        "depth_off_share": float(np.mean(rel > 0.01)),
        "cost_gap_p50": float(np.median(cgap)),
        "depth_rel_p50": float(np.median(rel)),
        "depth_rel_p90": float(np.quantile(rel, 0.9)),
        "depth_same_share": float(np.mean(rel <= 1e-6)),
        "cost_gap_p90": float(np.quantile(cgap, 0.9)),
        "cost_gap_mean": float(np.mean(np.minimum(cgap, 10.0))),
        "normal_off_share": float(np.mean(cos < np.cos(np.radians(5.0)))),
    }


def worst(gaps: list) -> dict:
    """Each number's largest reading over several views."""
    return {k: max(g[k] for g in gaps) for k in gaps[0]}
