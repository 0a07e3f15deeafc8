"""Cross-method statistics over per-scan metric vectors — the port's copy
of ``acmmp_tpu/eval/stats.py``.

Replaces python_scripts/dtu_statistics.py (pandas/statsmodels there): builds
the (method, scan, ncam) -> 12-metric array and runs paired t-tests with
Holm multiple-test correction across methods, using only numpy/scipy."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from acmmp_tpu_torch.eval.dtu import METRIC_NAMES


class MetricTable:
    """metrics[(method, scan, ncam)] = 12-vector."""

    def __init__(self):
        self.rows: Dict[Tuple[str, str, int], np.ndarray] = {}

    def add(self, method: str, scan: str, ncam: int, metrics: Dict[str, float]):
        self.rows[(method, scan, ncam)] = np.array(
            [metrics[k] for k in METRIC_NAMES], np.float64)

    def methods(self) -> List[str]:
        return sorted({m for (m, _, _) in self.rows})

    def matrix(self, method: str, ncam=None) -> np.ndarray:
        keys = sorted(
            (s, c) for (m, s, c) in self.rows
            if m == method and (ncam is None or c == ncam))
        return np.stack([self.rows[(method, s, c)] for s, c in keys])

    def paired_keys(self, m1: str, m2: str, ncam=None):
        k1 = {(s, c) for (m, s, c) in self.rows
              if m == m1 and (ncam is None or c == ncam)}
        k2 = {(s, c) for (m, s, c) in self.rows
              if m == m2 and (ncam is None or c == ncam)}
        return sorted(k1 & k2)


def holm_correction(pvals: Sequence[float]) -> np.ndarray:
    """Holm step-down adjusted p-values."""
    p = np.asarray(pvals, np.float64)
    order = np.argsort(p)
    adj = np.empty_like(p)
    running = 0.0
    m = len(p)
    for rank, idx in enumerate(order):
        running = max(running, (m - rank) * p[idx])
        adj[idx] = min(running, 1.0)
    return adj


def paired_tests(table: MetricTable, metric: str, ncam=None):
    """All-pairs paired t-tests on one metric, Holm-corrected.

    Returns list of (method_a, method_b, mean_diff, p_adj)."""
    from scipy import stats

    mi = METRIC_NAMES.index(metric)
    methods = table.methods()
    rows = []
    pvals = []
    for i in range(len(methods)):
        for j in range(i + 1, len(methods)):
            keys = table.paired_keys(methods[i], methods[j], ncam)
            if len(keys) < 2:
                continue
            a = np.array([table.rows[(methods[i], s, c)][mi] for s, c in keys])
            b = np.array([table.rows[(methods[j], s, c)][mi] for s, c in keys])
            t, p = stats.ttest_rel(a, b)
            rows.append([methods[i], methods[j], float((a - b).mean())])
            pvals.append(float(p) if np.isfinite(p) else 1.0)
    adj = holm_correction(pvals) if pvals else np.zeros(0)
    return [tuple(r) + (float(q),) for r, q in zip(rows, adj)]
