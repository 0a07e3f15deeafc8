"""[The benchmark's plain reference: a frozen copy of the program's
`acmmp_tpu_torch/ops/median.py`, its plain (non-kernel) path only, importing
nothing of the program. Its original text follows.]

Checkerboard median depth filter (CheckerboardFilter,
src/ACMMP.cu:1214-1328) — the port of ``acmmp_tpu/ops/median.py``.

21 cross/diagonal taps; the masked median (taps outside the true image
excluded) replaces the depth unless the pixel's cost is under
``filter_cost_skip``. Two masked passes (black, then red) reproduce the
reference's sequential launches (ACMMP.cu:1445-1447)."""

from __future__ import annotations

import torch

from h100bench.reference.params import PatchMatchParams
from h100bench.reference.propagation import BIG, _inside, shift_fill

# (dx, dy) taps, centre first (ACMMP.cu:1227-1319)
_TAPS = (
    (0, 0),
    (0, -1), (0, -3), (0, -5),
    (0, 1), (0, 3), (0, 5),
    (-1, 0), (-3, 0), (-5, 0),
    (1, 0), (3, 0), (5, 0),
    (2, -1), (2, 1), (-2, -1), (-2, 1),
    (-1, -2), (1, -2), (-1, 2), (1, 2),
)


def checkerboard_median(depth, costs, x, y, width_true, height_true,
                        parity_mask, params: PatchMatchParams) -> torch.Tensor:
    vals, valid = [], []
    for (dx, dy) in _TAPS:
        v = _inside(x, y, dx, dy, width_true, height_true)
        vals.append(torch.where(v, shift_fill(depth, dy, dx, BIG), BIG))
        valid.append(v)
    n = torch.stack(valid).sum(0)                  # valid tap count (>= 1)
    s = torch.sort(torch.stack(vals), dim=0).values  # invalid (BIG) last
    mi = n // 2
    lo = torch.gather(s, 0, torch.clamp(mi - 1, min=0)[None])[0]
    hi = torch.gather(s, 0, mi[None])[0]
    med = torch.where(n % 2 == 0, 0.5 * (lo + hi), hi)
    update = parity_mask & (costs >= params.filter_cost_skip)
    return torch.where(update, med, depth)
