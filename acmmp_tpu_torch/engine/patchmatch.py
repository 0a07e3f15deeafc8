"""The per-view PatchMatch solver — the port of
``acmmp_tpu/engine/patchmatch.py``, photometric mode (``Mode()``).

One solve: a random-plane init scored once (K=1), then ``2*max_iterations``
red/black half-sweeps, each scoring 8 propagation candidates (K=8) and 5
refinement candidates (K=3 + K=2) and carrying the current plane's costs
over, then depth/normal extraction and the two-pass checkerboard median.
On CUDA tensors that is 1 + 3 * 2*max_iterations launches of the ZNCC
kernel per solve (ops/cuda_ncc.py).

The JAX package's solve is one traced program; here it is a host loop over
eager tensor ops. Its TPU-only scheduling (the fused/staged split,
``first_sweep_coherent``, scan sub-stacking) changes no result and is not
ported. The other modes (geometric consistency, planar prior, hierarchy,
seeded init) are ROADMAP.md Queue 1 item 8 and raise here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.core import geometry as geo
from acmmp_tpu_torch.ops import keys
from acmmp_tpu_torch.ops import ncc as ncc_ops
from acmmp_tpu_torch.ops import parity as parity_ops
from acmmp_tpu_torch.ops import pixel_rng as prng
from acmmp_tpu_torch.ops import propagation as prop_ops
from acmmp_tpu_torch.ops import sampling as samp_ops
from acmmp_tpu_torch.ops.median import checkerboard_median


@dataclasses.dataclass(frozen=True)
class Mode:
    """Solver mode flags (PatchMatchParams bools, src/ACMMP.h:50-55)."""

    geom_consistency: bool = False
    planar_prior: bool = False
    hierarchy: bool = False
    seeded: bool = False


class SolverInputs(NamedTuple):
    """Inputs of one (view, scale) photometric solve; shapes are padded,
    true bounds ride in the cameras. The optional fields of the JAX
    package's SolverInputs belong to the modes not ported yet."""

    ref_img: torch.Tensor          # [H, W] grayscale, edge-padded
    src_imgs: torch.Tensor         # [V, Hs, Ws]
    ref_cam: geo.Camera            # scalar camera
    src_cams: geo.Camera           # stacked [V]
    view_mask: torch.Tensor        # [V] bool
    depth_min: torch.Tensor        # scalar, relaxed range
    depth_max: torch.Tensor        # scalar


class SolverState(NamedTuple):
    planes: torch.Tensor     # [H, W, 4] camera-frame plane hypotheses
    costs: torch.Tensor      # [H, W]
    selected: torch.Tensor   # [H, W, V] bool
    pre_costs: torch.Tensor  # [H, W]
    # per-view costs of the CURRENT plane field, carried across sweeps so
    # the 9th propagation hypothesis needs no re-scoring (ACMMP.cu:1060-1062)
    ncc_pv: torch.Tensor     # [H, W, V]


class SolverOutputs(NamedTuple):
    depth: torch.Tensor         # [H, W]
    normal_world: torch.Tensor  # [H, W, 3]
    cost: torch.Tensor          # [H, W]
    pre_costs: torch.Tensor     # [H, W]


def _check_mode(mode: Mode) -> None:
    if mode != Mode():
        raise NotImplementedError(
            f"acmmp_tpu_torch solves only the photometric Mode() so far; "
            f"{mode} is ROADMAP.md Queue 1 item 8 (the remaining solver modes)")


def effective_params(params: PatchMatchParams, H: int,
                     W: int) -> PatchMatchParams:
    """Shape gate of the windowed random-depth law (DEVIATIONS.md #18):
    below `rand_window_min_tiles` (16, 128) tiles of the FULL padded image
    the solver draws from the exact full range."""
    if not params.rand_depth_tile_window:
        return params
    tiles = ((-(-H // samp_ops.WINDOW_TILE_ROWS))
             * (-(-W // samp_ops.WINDOW_TILE_COLS)))
    if tiles >= params.rand_window_min_tiles:
        return params
    return dataclasses.replace(params, rand_depth_tile_window=0.0)


class _Context:
    """Per-solve constants: pixel grids, homography constants, the true
    view count (a host int, read once per solve) and the ZNCC kernel's
    per-layout preparation (built on first use, CUDA tensors only)."""

    def __init__(self, inputs: SolverInputs, params: PatchMatchParams):
        H, W = inputs.ref_img.shape
        dev = inputs.ref_img.device
        self.inputs = inputs
        self.params = params
        self.x, self.y = geo.pixel_grid(H, W, device=dev)
        self.black = ((self.x.long() + self.y.long()) % 2) == 0
        self.vg = ncc_ops.make_view_geometry(inputs.ref_cam, inputs.src_cams)
        self.n_views = int(inputs.view_mask.sum())
        self.use_kernel = ncc_ops.use_kernel(params, inputs.ref_img)
        self._preps = {}

    def prep(self, off0: Optional[int]):
        if not self.use_kernel:
            return None
        if off0 not in self._preps:
            from acmmp_tpu_torch.ops import cuda_ncc

            self._preps[off0] = cuda_ncc.prepare(
                self.inputs.ref_img, self.inputs.src_imgs, self.vg,
                self.params, off0)
        return self._preps[off0]

    def zncc(self, planes, off0: Optional[int] = None):
        """Per-view costs of `planes` on the full grid (off0 None) or the
        parity-packed half grid of offset off0."""
        inp = self.inputs
        if off0 is None:
            return ncc_ops.multiview_zncc(
                inp.ref_img, inp.src_imgs, self.vg, planes, self.params,
                n_views=self.n_views, prep=self.prep(None))
        return ncc_ops.multiview_zncc_packed(
            inp.ref_img, inp.src_imgs, self.vg, planes, self.params, off0,
            n_views=self.n_views, prep=self.prep(off0))


# ---------------------------------------------------------------------------
# initialization (RandomInitialization, ACMMP.cu:609-705), random branch
# ---------------------------------------------------------------------------

def _init_state(inputs: SolverInputs, params: PatchMatchParams,
                key: keys.Key, ctx: _Context) -> SolverState:
    planes = samp_ops.random_plane(
        key, inputs.ref_cam, ctx.x, ctx.y, inputs.depth_min,
        inputs.depth_max, tile_window=params.rand_depth_tile_window,
        min_cos=params.rand_normal_min_cos)
    per_view = ctx.zncc(planes)
    costs, selected = ncc_ops.initial_cost_and_views(
        per_view, inputs.view_mask, params)
    # pre_costs: the init costs, threaded out for a follow-up pass
    return SolverState(planes=planes, costs=costs, selected=selected,
                       pre_costs=costs, ncc_pv=per_view)


# ---------------------------------------------------------------------------
# one checkerboard half-sweep
# ---------------------------------------------------------------------------

def _aggregate(costs_pv, weights, weight_norm):
    """Weighted multiview aggregation sum_j w_j ncc_j / max(norm, 1)."""
    return (weights * costs_pv).sum(-1) / torch.clamp(weight_norm, min=1.0)


def _take(stack: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """stack[idx[p], p] for a leading candidate axis (trailing channel axes
    of `stack` beyond idx's dims are kept)."""
    extra = stack.ndim - 1 - idx.ndim
    i = idx.reshape((1,) + idx.shape + (1,) * extra)
    return torch.gather(stack, 0, i.expand((1,) + stack.shape[1:]))[0]


def _sweep(state: SolverState, inputs: SolverInputs, ctx: _Context,
           parity_odd: int, iteration: int, key: keys.Key,
           params: PatchMatchParams) -> SolverState:
    cam = inputs.ref_cam
    H, W = inputs.ref_img.shape
    dmin, dmax = inputs.depth_min, inputs.depth_max
    wt, ht = cam.width, cam.height
    x, y = ctx.x, ctx.y
    BIG = prop_ops.BIG
    k_view, k_refine = keys.split(key)
    parity_mask = ~ctx.black if parity_odd else ctx.black

    # ---- adaptive checkerboard sampling and the view-selection prior
    # (full grid: they read opposite-parity neighbours) ----
    cand_planes, flags = prop_ops.best_neighbor_planes(
        state.costs, state.planes, x, y, wt, ht, params)
    prior = prop_ops.view_prior(state.selected, x, y, wt, ht, params)

    # ---- the rest only matters at the active parity: score the
    # hypotheses on the parity row-packed half grid ----
    packed = params.parity_packed and (H % 16 == 0)
    if packed:
        off0 = parity_odd      # the active parity's row offset at (0, 0)
        pk = lambda a: parity_ops.pack_rows(a, off0)            # noqa: E731
        pkc = lambda a: parity_ops.pack_rows_c(a, off0)         # noqa: E731
    else:
        off0 = None
        pk = pkc = lambda a: a                                  # noqa: E731
    x, y = pk(x), pk(y)
    planes_cur = pkc(state.planes)
    sel_prev = pkc(state.selected)
    pv_cur = pkc(state.ncc_pv)
    cand_planes = pkc(cand_planes)
    flags = pk(flags)
    prior = pkc(prior)

    # the 8 propagation candidates (K=8); the 9th, the current plane, is
    # carried, not re-scored
    ncc8 = ctx.zncc(cand_planes.contiguous(), off0)             # [8, *g, V]
    ncc9 = torch.cat([ncc8, pv_cur[None]], dim=0)

    # ---- multi-hypothesis joint view selection ----
    weights, weight_norm, new_selected = prop_ops.view_selection_core(
        ncc8, flags, prior, inputs.view_mask, x, y, k_view, iteration, params)
    has_views = weight_norm > 0.0

    agg9 = _aggregate(ncc9, weights[None], weight_norm[None])   # [9, *g]
    final_costs = torch.where(flags, agg9[:8], BIG)
    cost_now = agg9[8]
    cand_depths = geo.depth_from_plane(cam, cand_planes, x, y)  # [8, *g]
    depth_ok = (cand_depths >= dmin) & (cand_depths <= dmax)
    gated = torch.where(depth_ok, final_costs, BIG)

    best = torch.argmin(gated, dim=0)                           # [*g]
    best_cost = _take(gated, best)
    improve = (best_cost < cost_now) & has_views
    plane_prop = torch.where(improve[..., None], _take(cand_planes, best),
                             planes_cur)
    cost_prop = torch.where(improve, best_cost, cost_now)
    sel_prop = torch.where(improve[..., None], new_selected, sel_prev)
    pv_prop = torch.where(improve[..., None], _take(ncc8, best), pv_cur)

    # ---- plane refinement: 5 candidates (PlaneHypothesisRefinement) ----
    depth_now = geo.depth_from_plane(cam, plane_prop, x, y)
    normal_now = plane_prop[..., :3]
    kd_r, kn_r, kd_p, kn_p = keys.split(k_refine, 4)
    depth_rand = samp_ops.random_depth(
        kd_r, dmin, dmax, y, x, tile_window=params.rand_depth_tile_window)
    normal_rand = samp_ops.random_unit_normal(
        kn_r, cam, x, y, depth_now, min_cos=params.rand_normal_min_cos)
    pert = params.refine_perturbation
    u = prng.uniform(kd_p, y, x, 0)
    depth_pert = depth_now * (1.0 - pert) + u * (2.0 * pert * depth_now)
    normal_pert = samp_ops.perturbed_normal(kn_p, cam, x, y, normal_now,
                                            pert * math.pi)

    cand_d = torch.stack([depth_rand, depth_now, depth_rand, depth_now,
                          depth_pert])
    cand_n = torch.stack([normal_now, normal_rand, normal_rand, normal_pert,
                          normal_now])
    planes5 = geo.plane_from_depth_normal(cam, x, y, cand_d, cand_n)
    # two stacks that share a centre warp per pixel: {1, 3, 4} keep the
    # incumbent depth (K=3), {0, 2} share the random depth (K=2); the
    # costs are those of five single scorings
    ncc_now = ctx.zncc(planes5[[1, 3, 4]], off0)
    ncc_rand = ctx.zncc(planes5[[0, 2]], off0)
    ncc5 = torch.stack([ncc_rand[0], ncc_now[0], ncc_rand[1], ncc_now[1],
                        ncc_now[2]])
    cost5 = _aggregate(ncc5, weights[None], weight_norm[None])  # [5, *g]
    d_ok5 = (cand_d >= dmin) & (cand_d <= dmax)
    g5 = torch.where(d_ok5, cost5, BIG)
    bi = torch.argmin(g5, dim=0)
    bc = _take(g5, bi)
    imp = (bc < cost_prop) & has_views
    new_planes = torch.where(imp[..., None], _take(planes5, bi), plane_prop)
    new_costs = torch.where(imp, bc, cost_prop)
    new_pv = torch.where(imp[..., None], _take(ncc5, bi), pv_prop)

    # ---- masked parity write; pixels whose view re-sampling selected no
    # view keep their previous state (DEVIATIONS.md) ----
    if packed:
        unp, unpc = parity_ops.unpack_rows, parity_ops.unpack_rows_c
    else:
        unp = unpc = lambda a: a                                # noqa: E731
    upd = parity_mask & unp(has_views)
    upd3 = upd[..., None]
    return SolverState(
        planes=torch.where(upd3, unpc(new_planes), state.planes),
        costs=torch.where(upd, unp(new_costs), state.costs),
        selected=torch.where(upd3, unpc(sel_prop), state.selected),
        pre_costs=state.pre_costs,
        ncc_pv=torch.where(upd3, unpc(new_pv), state.ncc_pv),
    )


# ---------------------------------------------------------------------------
# full solve
# ---------------------------------------------------------------------------

def finalize(state: SolverState, inputs: SolverInputs,
             params: PatchMatchParams) -> SolverOutputs:
    """Plane -> (depth, world normal) + checkerboard median
    (GetDepthandNormal + Black/RedPixelFilter, ACMMP.cu:1199-1212,
    1445-1447)."""
    H, W = inputs.ref_img.shape
    x, y = geo.pixel_grid(H, W, device=inputs.ref_img.device)
    cam = inputs.ref_cam
    black = ((x.long() + y.long()) % 2) == 0
    depth = geo.depth_from_plane(cam, state.planes, x, y)
    normal_world = geo.normal_cam_to_world(cam, state.planes[..., :3])
    for mask in (black, ~black):
        depth = checkerboard_median(depth, state.costs, x, y, cam.width,
                                    cam.height, mask, params)
    return SolverOutputs(depth=depth, normal_world=normal_world,
                         cost=state.costs, pre_costs=state.pre_costs)


def run_patchmatch(inputs: SolverInputs, key: keys.Key,
                   params: PatchMatchParams,
                   mode: Mode = Mode()) -> SolverOutputs:
    """One full PatchMatch solve for one reference view, on the device of
    `inputs` (a host loop: init, 2*max_iterations half-sweeps, finalize).
    Keys follow the JAX package: ``k_init, k_sweeps = split(key)`` and
    sweep s uses ``fold_in(k_sweeps, s)``, iteration s // 2, parity s % 2."""
    _check_mode(mode)
    H, W = inputs.ref_img.shape
    params = effective_params(params, H, W)
    ctx = _Context(inputs, params)
    k_init, k_sweeps = keys.split(key)
    state = _init_state(inputs, params, k_init, ctx)
    for s in range(2 * params.max_iterations):
        state = _sweep(state, inputs, ctx, s % 2, s // 2,
                       keys.fold_in(k_sweeps, s), params)
    return finalize(state, inputs, params)
