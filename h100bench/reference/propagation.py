"""[The benchmark's plain reference: a frozen copy of the program's
`acmmp_tpu_torch/ops/propagation.py`, its plain (non-kernel) path only, importing
nothing of the program. Its original text follows.]

Adaptive checkerboard sampling and multi-hypothesis joint view selection
— the port of ``acmmp_tpu/ops/propagation.py``.

The reference's per-thread loops (CheckerboardPropagation,
src/ACMMP.cu:786-1173) are whole-image tensor ops: each of the 8 sampling
regions is a small stack of shifted cost maps with an argmin (first index
on ties, as ``jnp.argmin``), and view re-sampling is a 15-sample
Monte-Carlo CDF inversion over [*grid, V]. Deviations from the reference
are the JAX package's (DEVIATIONS.md): invalid border regions are
excluded, and right_far takes its min-cost member unless
``reproduce_right_far_quirk`` is set (ACMMP.cu:879).

Every function takes an optional leading batch axis on its per-pixel
fields ([B, H, W], [B, H, W, V]; candidate stacks [8, B, H, W, ...]),
with the true bounds and the view mask broadcastable against them: each
view of a batch gets what its own call gets, and every candidate
reduction stays on axis 0.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from h100bench.reference.params import PatchMatchParams
from h100bench.reference import keys
from h100bench.reference import pixel_rng as prng

BIG = 1e9


def direction_candidates(params: PatchMatchParams) -> List[List[Tuple[int, int]]]:
    """Candidate (dx, dy) offsets for the 8 regions, base candidate first:
    0 up_near, 1 up_far, 2 down_near, 3 down_far, 4 left_near, 5 left_far,
    6 right_near, 7 right_far (ACMMP.cu:806)."""
    L = params.near_v_levels
    F_ = params.far_strip_candidates

    def near(sx, sy):
        # V-shaped region: base one step away, then two diagonals per level
        if sy != 0:
            out = [(0, sy)]
            for i in range(L):
                dy = sy * (2 + i)
                out += [(0, dy)] if i == 0 else [(-i, dy), (i, dy)]
        else:
            out = [(sx, 0)]
            for i in range(L):
                dx = sx * (2 + i)
                out += [(dx, 0)] if i == 0 else [(dx, -i), (dx, i)]
        return out

    def far(sx, sy):
        return [(sx * (3 + 2 * i), sy * (3 + 2 * i)) for i in range(F_)]

    return [near(0, -1), far(0, -1), near(0, 1), far(0, 1),
            near(-1, 0), far(-1, 0), near(1, 0), far(1, 0)]


def shift_fill(arr: torch.Tensor, dy: int, dx: int,
               fill: float) -> torch.Tensor:
    """out[..., y, x] = arr[..., y+dy, x+dx], `fill` out of bounds."""
    H, W = arr.shape[-2], arr.shape[-1]
    py, px = abs(dy), abs(dx)
    padded = F.pad(arr, (px, px, py, py), mode="constant", value=fill)
    return padded[..., py + dy:py + dy + H, px + dx:px + dx + W]


def _inside(x, y, dx, dy, width_true, height_true):
    return ((x + dx >= 0) & (x + dx < width_true)
            & (y + dy >= 0) & (y + dy < height_true))


def best_neighbor_planes(costs, planes, x, y, width_true, height_true,
                         params: PatchMatchParams):
    """For each of the 8 regions pick the min-cost member's plane.
    costs [..., H, W], planes [..., H, W, 4]. Returns (cand_planes
    [8, ..., H, W, 4], flags [8, ..., H, W] bool)."""
    H, W = costs.shape[-2:]
    lead = costs.shape[:-2]
    planes_flat = planes.reshape(lead + (H * W, 4))
    yl = torch.arange(H, device=costs.device)[:, None]
    xl = torch.arange(W, device=costs.device)[None, :]
    cand_planes, flags = [], []
    for d, cands in enumerate(direction_candidates(params)):
        shifted, valids = [], []
        for (dx, dy) in cands:
            v = _inside(x, y, dx, dy, width_true, height_true)
            shifted.append(torch.where(v, shift_fill(costs, dy, dx, BIG), BIG))
            valids.append(v)
        cand_costs = torch.stack(shifted)               # [C, H, W]
        if d == 7 and params.reproduce_right_far_quirk:
            # reference quirk: right_far keeps a *costlier* member
            # (ACMMP.cu:871-887) — max over the valid members
            masked = torch.where(torch.stack(valids), cand_costs, -BIG)
            idx = torch.argmax(masked, dim=0)
        else:
            idx = torch.argmin(cand_costs, dim=0)       # [H, W]
        offs = torch.tensor(cands, dtype=torch.long, device=costs.device)
        gx = torch.clamp(xl + offs[idx, 0], 0, W - 1)
        gy = torch.clamp(yl + offs[idx, 1], 0, H - 1)
        flat = (gy * W + gx).reshape(lead + (H * W, 1))
        cand_planes.append(torch.gather(
            planes_flat, -2, flat.expand(lead + (H * W, 4))).reshape(
                lead + (H, W, 4)))
        flags.append(valids[0])
    return torch.stack(cand_planes), torch.stack(flags)


def view_prior(selected, x, y, width_true, height_true,
               params: PatchMatchParams) -> torch.Tensor:
    """Per-view spatial prior from the 4 adjacent pixels' previous
    selections (ACMMP.cu:994-1008); full grid, selected [..., H, W, V]."""
    sel = selected.to(torch.float32).movedim(-1, -3)    # [..., V, H, W]
    prior = torch.zeros(selected.shape, dtype=torch.float32,
                        device=selected.device)
    for (dx, dy) in ((0, -1), (0, 1), (-1, 0), (1, 0)):
        v = _inside(x, y, dx, dy, width_true, height_true)
        nb_sel = shift_fill(sel, dy, dx, 0.0).movedim(-3, -1)
        contrib = torch.where(nb_sel > 0.5, params.view_prior_selected,
                              params.view_prior_unselected)
        prior = prior + torch.where(v[..., None], contrib, 0.0)
    return prior


def view_selection_core(cost_array, flags, prior, view_mask, x, y,
                        key: keys.AnyKey, iteration, params: PatchMatchParams):
    """Evidence aggregation + Monte-Carlo view re-sampling over any grid.
    cost_array [8, *grid, V], flags [8, *grid], prior [*grid, V],
    view_mask broadcastable to [*grid, V]; x/y are GLOBAL pixel
    coordinates (RNG counters). `*grid` may lead with a batch axis, `key`
    then a KeyBatch. Returns (weights [*grid, V], weight_norm [*grid],
    new_selected [*grid, V] bool)."""
    V = cost_array.shape[-1]
    it = torch.tensor(float(iteration), dtype=torch.float32,
                      device=cost_array.device)
    thr = params.cost_threshold_base * torch.exp(
        (it * it) / (-params.cost_threshold_decay))
    fl = flags[..., None]
    good = (cost_array < thr) & fl
    false_ = (cost_array > params.cost_false_threshold) & fl
    tmpw = torch.where(good, torch.exp(cost_array * cost_array
                                       / (-params.cost_good_beta)), 0.0).sum(0)
    count = good.sum(0).to(torch.float32)
    count_false = false_.sum(0)
    fallback = torch.exp(thr * thr / (-params.cost_fallback_beta))
    probs = torch.where(count > params.min_good_hypotheses,
                        tmpw / torch.clamp(count, min=1.0), fallback)
    probs = torch.where(count_false < params.max_false_hypotheses, probs, 0.0)
    probs = probs * prior * view_mask.to(torch.float32)

    # Monte-Carlo CDF inversion, 15 samples (ACMMP.cu:1034-1045)
    total = probs.sum(-1, keepdim=True)
    cdf = torch.cumsum(probs, dim=-1) / torch.clamp(total, min=1e-30)
    cdf = torch.where(total > 0.0, cdf, -1.0)   # no mass -> never selected
    u = (prng.uniform_n(key, y, x, 0, params.num_view_samples)
         - torch.finfo(torch.float32).eps)
    # first index with cdf > u == number of cdf entries <= u
    idx = (cdf[None] <= u[..., None]).sum(-1)               # [S, *grid]
    # per-view sample counts (jax.nn.one_hot(idx, V+1)[..., :V] summed)
    views = torch.arange(V, device=idx.device)
    weights = (idx[..., None] == views).sum(0).to(torch.float32)
    weight_norm = weights.sum(-1)
    return weights, weight_norm, weights > 0.0
