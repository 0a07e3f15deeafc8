"""[The benchmark's plain reference: a frozen copy of the program's
`acmmp_tpu_torch/engine/patchmatch.py`, its plain (non-kernel) path only, importing
nothing of the program. Its original text follows.]

The per-view PatchMatch solver — the port of
``acmmp_tpu/engine/patchmatch.py``, every solver mode.

One solve: an init scored once (K=1), then ``2*max_iterations`` red/black
half-sweeps, each scoring 8 propagation candidates (K=8) and 5
refinement candidates (K=3 + K=2) and carrying the current plane's costs
over, then depth/normal extraction and the two-pass checkerboard median.
On CUDA tensors that is 1 + 3 * 2*max_iterations launches of the ZNCC
kernel per solve (ops/cuda_ncc.py); a geometric-consistency solve adds
1 + 2 * 2*max_iterations launches of the geom kernel (ops/cuda_geom.py:
K=1 at init, K=8 and K=5 per half-sweep).

Modes (``Mode``, the reference's PatchMatchParams bools): seeded init from
given planes; planar-prior re-entry with the restricted score; hierarchy
re-entry with its acceptance gate; geometric consistency against the
source views' depth maps; and their combinations. A mode whose input is
missing raises ValueError naming the field.

The JAX package's solve is one traced program; here it is a host loop over
eager tensor ops. Its TPU-only scheduling (the fused/staged split,
``first_sweep_coherent``, scan sub-stacking) changes no result and is not
ported.

The solver works on a batch of B reference views of one shape
(``run_patchmatch_batch``): every field carries a leading [B], the
hypothesis stacks are candidate-major ([K, B, H, W, ...], so every
candidate reduction stays on axis 0), the reference camera's fields
broadcast as [B, 1, 1] (geometry.insert_dims) and each view draws from
its own key (keys.KeyBatch). A batch issues the launches of one solve,
each doing B views' work, and each view gets what its own solve gets.
The stage functions take a batch; ``one_view`` runs one of them on a
single view as the batch of one, through zero-copy views, and
``run_patchmatch`` is ``run_patchmatch_batch`` so lifted. Several
batches, each on its own device (the members of a device mesh,
parallel/), advance in lock-step through ``run_patchmatch_members``;
a row tile of a larger image solves at its tile origin (``_Context``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Optional, Sequence

import torch

from h100bench.reference.params import PatchMatchParams
from h100bench.reference import geometry as geo
from h100bench.reference import geom as geom_ops
from h100bench.reference import keys
from h100bench.reference import ncc as ncc_ops
from h100bench.reference import parity as parity_ops
from h100bench.reference import pixel_rng as prng
from h100bench.reference import propagation as prop_ops
from h100bench.reference import sampling as samp_ops
from h100bench.reference.median import checkerboard_median


@dataclasses.dataclass(frozen=True)
class Mode:
    """Solver mode flags (PatchMatchParams bools, src/ACMMP.h:50-55)."""

    geom_consistency: bool = False
    planar_prior: bool = False
    hierarchy: bool = False
    seeded: bool = False


class SolverInputs(NamedTuple):
    """Inputs of one (view, scale, mode) solve; shapes are padded, true
    bounds ride in the cameras. Optional fields are None unless the mode
    needs them. A batch's fields lead with [B] (cameras [B] and [B, V],
    the depth range [B]): parallel/sharding.stack_solver_inputs."""

    ref_img: torch.Tensor          # [H, W] grayscale, edge-padded
    src_imgs: torch.Tensor         # [V, Hs, Ws]
    ref_cam: geo.Camera            # scalar camera
    src_cams: geo.Camera           # stacked [V]
    view_mask: torch.Tensor        # [V] bool
    depth_min: torch.Tensor        # scalar, relaxed range
    depth_max: torch.Tensor        # scalar
    src_depths: Optional[torch.Tensor] = None         # [V, Hs, Ws] (geom)
    init_depth: Optional[torch.Tensor] = None         # [H, W] re-entry depth
    init_normal_world: Optional[torch.Tensor] = None  # [H, W, 3]
    init_cost: Optional[torch.Tensor] = None          # [H, W] re-entry costs
    prior_planes: Optional[torch.Tensor] = None       # [H, W, 4] planar prior
    prior_mask: Optional[torch.Tensor] = None         # [H, W] bool
    seed_planes: Optional[torch.Tensor] = None        # [H, W, 4] seeded init
    pre_costs: Optional[torch.Tensor] = None          # [H, W] hierarchy gate


class SolverState(NamedTuple):
    planes: torch.Tensor     # [H, W, 4] camera-frame plane hypotheses
    costs: torch.Tensor      # [H, W]
    selected: torch.Tensor   # [H, W, V] bool
    pre_costs: torch.Tensor  # [H, W] (hierarchy acceptance gate)
    # per-view costs of the CURRENT plane field, carried across sweeps so
    # the 9th propagation hypothesis needs no re-scoring (ACMMP.cu:1060-1062)
    ncc_pv: torch.Tensor     # [H, W, V]
    geom_pv: Optional[torch.Tensor] = None   # [H, W, V] (geom mode only)


class SolverOutputs(NamedTuple):
    depth: torch.Tensor         # [H, W]
    normal_world: torch.Tensor  # [H, W, 3]
    cost: torch.Tensor          # [H, W]
    pre_costs: torch.Tensor     # [H, W]


def batch_of_one(t):
    """A single view's SolverInputs, SolverState or SolverOutputs as a
    batch of one (zero-copy views)."""
    def lift(a):
        if a is None:
            return None
        if isinstance(a, geo.Camera):
            return geo.insert_dims(a, 0, 1)
        return a[None]
    return type(t)(*(lift(a) for a in t))


def view_of(t, b: int):
    """View `b` of a batch's SolverInputs, SolverState or SolverOutputs
    (views of its tensors)."""
    def pick(a):
        if a is None:
            return None
        if isinstance(a, geo.Camera):
            return geo.index_camera(a, b)
        return a[b]
    return type(t)(*(pick(a) for a in t))


def _required_inputs(mode: Mode):
    """The optional SolverInputs fields `mode` reads: the init branch
    (seeded, else planar prior, else geometric/hierarchy re-entry, else
    random planes), plus the prior for the sweeps and the depth maps of
    the geometric cost."""
    if mode.seeded:
        need = ["seed_planes"]
    elif mode.planar_prior:
        need = ["init_depth", "init_normal_world", "init_cost"]
    elif mode.geom_consistency or mode.hierarchy:
        need = ["init_depth", "init_normal_world"]
    else:
        need = []
    if mode.planar_prior:
        need += ["prior_planes", "prior_mask"]
    if mode.geom_consistency:
        need.append("src_depths")
    return need


def _check_mode(mode: Mode, inputs: SolverInputs) -> None:
    for name in _required_inputs(mode):
        if getattr(inputs, name) is None:
            raise ValueError(f"{mode} needs SolverInputs.{name}, which is "
                             f"None")


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
    """Per-solve constants of a batch: pixel grids in image coordinates,
    the reference camera and depth range shaped to broadcast over
    [B, H, W], the view mask over [B, H, W, V], homography constants, the
    B true view counts (host ints, read once per batch) and the kernels'
    per-solve preparations (built on first use, CUDA tensors only).

    `origin` (host ints (y0, x0)) places the grid in a larger image: its
    pixel (r, c) is image pixel (y0 + r, x0 + c), as a row tile of
    parallel/tiles.py is. Pixel grids, the checkerboard parity, the
    random draws (keyed on image coordinates) and both kernels then see
    image coordinates; (0, 0), the default, is the whole image."""

    def __init__(self, inputs: SolverInputs, params: PatchMatchParams,
                 origin=(0, 0)):
        B, H, W = inputs.ref_img.shape
        dev = inputs.ref_img.device
        self.inputs = inputs
        self.params = params
        self.origin = (int(origin[0]), int(origin[1]))
        self.x, self.y = geo.pixel_grid(H, W, device=dev)
        if self.origin != (0, 0):
            self.y = self.y + float(self.origin[0])
            self.x = self.x + float(self.origin[1])
        self.black = ((self.x.long() + self.y.long()) % 2) == 0
        self.cam = geo.insert_dims(inputs.ref_cam, 1, 2)
        self.dmin = inputs.depth_min.reshape(B, 1, 1)
        self.dmax = inputs.depth_max.reshape(B, 1, 1)
        self.view_mask = inputs.view_mask[:, None, None, :]
        self.vg = ncc_ops.make_view_geometry(inputs.ref_cam, inputs.src_cams)
        self.n_views = inputs.view_mask.sum(-1).tolist()

    def row_pack_off(self, parity_odd: int) -> int:
        """off0 of the active parity's packed rows (ops/parity.py): 0 if
        the grid's pixel (0, 0) is of that parity, else 1."""
        return (parity_odd + self.origin[0] + self.origin[1]) % 2

    def _origin_arg(self, origin=None):
        origin = self.origin if origin is None else tuple(origin)
        return None if origin == (0, 0) else origin

    def zncc(self, planes, off0: Optional[int] = None):
        """Per-view costs of `planes` ([K, B, Hg, W, 4] or [B, Hg, W, 4])
        on the full grid (off0 None) or the parity-packed half grid of
        offset off0."""
        inp = self.inputs
        planes = planes.contiguous()
        origin = self._origin_arg()
        if off0 is None:
            return ncc_ops.multiview_zncc(
                inp.ref_img, inp.src_imgs, self.vg, planes, self.params,
                origin=origin, n_views=self.n_views)
        return ncc_ops.multiview_zncc_packed(
            inp.ref_img, inp.src_imgs, self.vg, planes, self.params, off0,
            origin=origin, n_views=self.n_views)

    def geom(self, planes, off0: Optional[int] = None, origin=None):
        """Per-view geometric costs of `planes` on the full grid (off0
        None) or the parity-packed half grid of offset off0, at the
        grid's origin or at `origin` (a grid of other rows of the same
        image)."""
        inp = self.inputs
        return geom_ops.geom_consistency_cost(
            inp.ref_cam, inp.src_cams, inp.src_depths, planes.contiguous(),
            self.params, row_pack_off=off0, n_views=self.n_views,
            origin=self._origin_arg(origin))


# ---------------------------------------------------------------------------
# initialization (RandomInitialization, ACMMP.cu:609-705)
# ---------------------------------------------------------------------------

def init_planes(inputs: SolverInputs, params: PatchMatchParams, mode: Mode,
                key: keys.KeyBatch, cam: geo.Camera, x, y, dmin,
                dmax) -> torch.Tensor:
    """The init's plane field [B, H, W, 4] on the grid (x, y) (image
    coordinates) of `inputs`' row fields: the reference's four init
    branches by `mode`. `cam`, `dmin` and `dmax` broadcast over
    [B, H, W]."""
    if mode.seeded:
        planes = inputs.seed_planes
    elif mode.planar_prior:
        # re-entry after a converged pass: keep the previous hypothesis,
        # but perturb around the triangulated prior plane where a prior
        # exists and the fit is still poor (ACMMP.cu:640-661). The
        # reference perturbs the plane offset w by +-3*2% (ACMMP.cu:645-650)
        n_cam = geo.normal_world_to_cam(cam, inputs.init_normal_world)
        keep = geo.plane_from_depth_normal(cam, x, y, inputs.init_depth,
                                           n_cam)
        kd, kn = keys.split(key)
        p3 = 3.0 * params.prior_init_perturbation
        w0 = inputs.prior_planes[..., 3]
        u = prng.uniform(kd, y, x, 0) * 2.0 - 1.0
        w_pert = w0 * (1.0 + p3 * u)
        n_pert = samp_ops.perturbed_normal(
            kn, cam, x, y, inputs.prior_planes[..., :3], p3 * math.pi)
        pert = torch.cat([n_pert, w_pert[..., None]], dim=-1)
        use_prior = inputs.prior_mask & (inputs.init_cost >= 0.1)
        planes = torch.where(use_prior[..., None], pert, keep)
    elif mode.geom_consistency or mode.hierarchy:
        # re-enter from the previous pass/scale's (world normal, depth)
        n_cam = geo.normal_world_to_cam(cam, inputs.init_normal_world)
        planes = geo.plane_from_depth_normal(cam, x, y, inputs.init_depth,
                                             n_cam)
    else:
        planes = samp_ops.random_plane(
            key, cam, x, y, dmin, dmax,
            tile_window=params.rand_depth_tile_window,
            min_cos=params.rand_normal_min_cos)
    return planes


def _init_state(inputs: SolverInputs, params: PatchMatchParams, mode: Mode,
                key: keys.KeyBatch, ctx: _Context) -> SolverState:
    planes = init_planes(inputs, params, mode, key, ctx.cam, ctx.x, ctx.y,
                         ctx.dmin, ctx.dmax)
    per_view = ctx.zncc(planes)
    costs, selected = ncc_ops.initial_cost_and_views(
        per_view, ctx.view_mask, params)
    geom_pv = None
    if mode.geom_consistency:
        geom_pv = ctx.geom(planes[None])[0]
    # pre_costs: the init costs, threaded out for a follow-up pass, unless
    # the caller hands the hierarchy gate its own
    pre_costs = costs if inputs.pre_costs is None else inputs.pre_costs
    return SolverState(planes=planes, costs=costs, selected=selected,
                       pre_costs=pre_costs, ncc_pv=per_view, geom_pv=geom_pv)


# ---------------------------------------------------------------------------
# one checkerboard half-sweep
# ---------------------------------------------------------------------------

def _aggregate(costs_pv, geom_pv, weights, weight_norm,
               params: PatchMatchParams):
    """Weighted multiview aggregation
    sum_j w_j (ncc_j + geom_weight geom_j) / max(norm, 1); `geom_pv` is
    None outside the geometric mode."""
    c = costs_pv
    if geom_pv is not None:
        c = c + params.geom_weight * geom_pv
    return (weights * c).sum(-1) / torch.clamp(weight_norm, min=1.0)


def _restricted_score(cost, depth, normal, prior_planes, prior_depth, dmin,
                      dmax, params: PatchMatchParams):
    """Planar-prior restricted score (bigger is better;
    ACMMP.cu:1105-1124)."""
    depth_sigma = (dmax - dmin) / params.prior_depth_sigma_div
    two_ds2 = 2.0 * depth_sigma * depth_sigma
    two_as2 = 2.0 * params.prior_angle_sigma ** 2
    dd = depth - prior_depth
    cosang = (prior_planes[..., :3] * normal).sum(-1)
    ang = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
    prior = params.prior_gamma + (torch.exp(-dd * dd / two_ds2)
                                  * torch.exp(-ang * ang / two_as2))
    return torch.exp(-cost * cost / params.prior_beta) * prior


def _take(stack: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """stack[idx[p], p] for a leading candidate axis (trailing channel axes
    of `stack` beyond idx's dims are kept; p may lead with the batch)."""
    extra = stack.ndim - 1 - idx.ndim
    i = idx.reshape((1,) + idx.shape + (1,) * extra)
    return torch.gather(stack, 0, i.expand((1,) + stack.shape[1:]))[0]


def _sweep(state: SolverState, inputs: SolverInputs, ctx: _Context,
           parity_odd: int, iteration: int, key: keys.KeyBatch,
           params: PatchMatchParams, mode: Mode) -> SolverState:
    cam = ctx.cam
    H, W = inputs.ref_img.shape[-2:]
    dmin, dmax = ctx.dmin, ctx.dmax
    wt, ht = cam.width, cam.height
    x, y = ctx.x, ctx.y
    BIG = prop_ops.BIG
    geom, planar = mode.geom_consistency, mode.planar_prior
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
        off0 = ctx.row_pack_off(parity_odd)
        pk = lambda a: parity_ops.pack_rows(a, off0)            # noqa: E731
        pkc = lambda a: parity_ops.pack_rows_c(a, off0)         # noqa: E731
    else:
        off0 = None
        pk = pkc = lambda a: a                                  # noqa: E731
    x, y = pk(x), pk(y)
    planes_cur = pkc(state.planes)
    sel_prev = pkc(state.selected)
    pre_costs_cur = pk(state.pre_costs) if mode.hierarchy else None
    pv_cur = pkc(state.ncc_pv)
    geom_cur = pkc(state.geom_pv) if geom else None
    cand_planes = pkc(cand_planes).contiguous()
    flags = pk(flags)
    prior = pkc(prior)
    if planar:
        prior_planes_in = pkc(inputs.prior_planes)
        prior_mask_in = pk(inputs.prior_mask)

    # the 8 propagation candidates (K=8); the 9th, the current plane, is
    # carried, not re-scored
    ncc8 = ctx.zncc(cand_planes, off0)                       # [8, B, *g, V]
    ncc9 = torch.cat([ncc8, pv_cur[None]], dim=0)
    geom8 = geom9 = None
    if geom:
        geom8 = ctx.geom(cand_planes, off0)
        geom9 = torch.cat([geom8, geom_cur[None]], dim=0)

    # ---- multi-hypothesis joint view selection ----
    weights, weight_norm, new_selected = prop_ops.view_selection_core(
        ncc8, flags, prior, ctx.view_mask, x, y, k_view, iteration, params)
    has_views = weight_norm > 0.0

    agg9 = _aggregate(ncc9, geom9, weights[None], weight_norm[None],
                      params)                                # [9, B, *g]
    final_costs = torch.where(flags, agg9[:8], BIG)
    cost_now = agg9[8]
    cand_depths = geo.depth_from_plane(cam, cand_planes, x, y)  # [8, B, *g]
    depth_ok = (cand_depths >= dmin) & (cand_depths <= dmax)
    gated = torch.where(depth_ok, final_costs, BIG)

    if not planar:
        best = torch.argmin(gated, dim=0)                       # [B, *g]
        best_cost = _take(gated, best)
        take = (best_cost < cost_now) & has_views
        plane_prop = torch.where(take[..., None], _take(cand_planes, best),
                                 planes_cur)
        cost_prop = torch.where(take, best_cost, cost_now)
        sel_prop = torch.where(take[..., None], new_selected, sel_prev)
        buffer_costs = cost_now
    else:
        prior_depth = geo.depth_from_plane(cam, prior_planes_in, x, y)
        # masked pixels: maximise the restricted score over the 8 regions
        r8 = _restricted_score(agg9[:8], cand_depths, cand_planes[..., :3],
                               prior_planes_in[None], prior_depth[None],
                               dmin, dmax, params)
        r8 = torch.where(flags & depth_ok, r8, -BIG)
        r_now = _restricted_score(
            cost_now, geo.depth_from_plane(cam, planes_cur, x, y),
            planes_cur[..., :3], prior_planes_in, prior_depth, dmin, dmax,
            params)
        best_r = torch.argmax(r8, dim=0)
        best_r_score = _take(r8, best_r)
        take_r = (best_r_score > r_now) & prior_mask_in & has_views
        # unmasked pixels: the standard min-cost acceptance
        best_c = torch.argmin(gated, dim=0)
        best_c_cost = _take(gated, best_c)
        take_c = (best_c_cost < cost_now) & (~prior_mask_in) & has_views
        best = torch.where(prior_mask_in, best_r, best_c)
        take = take_r | take_c
        plane_prop = torch.where(take[..., None], _take(cand_planes, best),
                                 planes_cur)
        cost_prop = torch.where(take, _take(agg9[:8], best), cost_now)
        restricted_prop = torch.where(take_r, best_r_score, r_now)
        sel_prop = torch.where(take_r[..., None], new_selected, sel_prev)
        buffer_costs = cost_now if mode.hierarchy else cost_prop
    # the hierarchy fallback is the PRE-sweep plane: the reference's
    # propagation and refinement only update locals, and the gate skips the
    # write-back on failure (ACMMP.cu:1163-1169). That also keeps the
    # carried ncc_pv / geom_pv consistent with the stored plane there.
    buffer_planes = planes_cur if mode.hierarchy else plane_prop

    # carry the adopted hypothesis's per-view costs forward
    pv_prop = torch.where(take[..., None], _take(ncc8, best), pv_cur)
    if geom:
        geom_prop = torch.where(take[..., None], _take(geom8, best), geom_cur)

    # ---- plane refinement: 5 candidates (PlaneHypothesisRefinement) ----
    depth_now = geo.depth_from_plane(cam, plane_prop, x, y)
    normal_now = plane_prop[..., :3]
    kd_r, kn_r, kd_p, kn_p = keys.split(k_refine, 4)
    depth_rand = samp_ops.random_depth(
        kd_r, dmin, dmax, y, x, tile_window=params.rand_depth_tile_window)
    normal_rand = samp_ops.random_unit_normal(
        kn_r, cam, x, y, depth_now, min_cos=params.rand_normal_min_cos)
    if planar:
        # prior pixels draw around the prior plane (ACMMP.cu:1126-1140)
        depth_sigma = (dmax - dmin) / params.prior_depth_sigma_div
        u = prng.uniform(kd_r, y, x, 16)
        d_rand_prior = (u * 6.0 * depth_sigma
                        + (prior_depth - 3.0 * depth_sigma))
        n_rand_prior = samp_ops.perturbed_normal(
            kn_r, cam, x, y, prior_planes_in[..., :3],
            params.prior_angle_sigma)
        depth_rand = torch.where(prior_mask_in, d_rand_prior, depth_rand)
        normal_rand = torch.where(prior_mask_in[..., None], n_rand_prior,
                                  normal_rand)
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
    geom5 = ctx.geom(planes5, off0) if geom else None
    cost5 = _aggregate(ncc5, geom5, weights[None], weight_norm[None],
                       params)                               # [5, B, *g]
    d_ok5 = (cand_d >= dmin) & (cand_d <= dmax)
    g5 = torch.where(d_ok5, cost5, BIG)
    bi = torch.argmin(g5, dim=0)
    if not planar:
        imp = (_take(g5, bi) < cost_prop) & has_views
    else:
        r5 = _restricted_score(cost5, cand_d, cand_n, prior_planes_in[None],
                               prior_depth[None], dmin, dmax, params)
        r5 = torch.where(d_ok5, r5, -BIG)
        bi_r = torch.argmax(r5, dim=0)
        imp_r = ((_take(r5, bi_r) > restricted_prop) & prior_mask_in
                 & has_views)
        imp_c = (_take(g5, bi) < cost_prop) & (~prior_mask_in) & has_views
        bi = torch.where(prior_mask_in, bi_r, bi)
        imp = imp_r | imp_c
    plane_ref = torch.where(imp[..., None], _take(planes5, bi), plane_prop)
    cost_ref = torch.where(imp, _take(cost5, bi), cost_prop)
    pv_ref = torch.where(imp[..., None], _take(ncc5, bi), pv_prop)
    if geom:
        geom_ref = torch.where(imp[..., None], _take(geom5, bi), geom_prop)

    # ---- hierarchy acceptance gate (ACMMP.cu:1163-1172) ----
    if mode.hierarchy:
        gate = cost_ref < pre_costs_cur - params.hierarchy_accept_margin
        new_planes = torch.where(gate[..., None], plane_ref, buffer_planes)
        new_costs = torch.where(gate, cost_ref, buffer_costs)
        # the buffer fallback is (planes_cur, cost_now): carried pv_cur
        new_pv = torch.where(gate[..., None], pv_ref, pv_cur)
        if geom:
            new_gpv = torch.where(gate[..., None], geom_ref, geom_cur)
    else:
        new_planes, new_costs, new_pv = plane_ref, cost_ref, pv_ref
        if geom:
            new_gpv = geom_ref

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
        geom_pv=(torch.where(upd3, unpc(new_gpv), state.geom_pv)
                 if geom else state.geom_pv),
    )


# ---------------------------------------------------------------------------
# full solve
# ---------------------------------------------------------------------------

def _context(inputs: SolverInputs, params: PatchMatchParams,
             mode: Mode) -> _Context:
    _check_mode(mode, inputs)
    H, W = inputs.ref_img.shape[-2:]
    return _Context(inputs, effective_params(params, H, W))


def init_state(inputs: SolverInputs, key: keys.KeyBatch,
               params: PatchMatchParams, mode: Mode) -> SolverState:
    """The solve's initialization alone (the JAX package's stage 1), of a
    batch (one view: one_view)."""
    ctx = _context(inputs, params, mode)
    return _init_state(inputs, ctx.params, mode, key, ctx)


def sweep_once(state: SolverState, inputs: SolverInputs, sweep_idx: int,
               key: keys.KeyBatch, params: PatchMatchParams,
               mode: Mode) -> SolverState:
    """One red/black half-sweep of a batch: even `sweep_idx` = black
    parity, odd = red (BlackPixelUpdate/RedPixelUpdate,
    ACMMP.cu:1175-1197)."""
    ctx = _context(inputs, params, mode)
    return _sweep(state, inputs, ctx, sweep_idx % 2, sweep_idx // 2, key,
                  ctx.params, mode)


def finalize(state: SolverState, inputs: SolverInputs,
             params: PatchMatchParams) -> SolverOutputs:
    """Plane -> (depth, world normal) + checkerboard median
    (GetDepthandNormal + Black/RedPixelFilter, ACMMP.cu:1199-1212,
    1445-1447), of a batch."""
    H, W = inputs.ref_img.shape[-2:]
    x, y = geo.pixel_grid(H, W, device=inputs.ref_img.device)
    cam = geo.insert_dims(inputs.ref_cam, 1, 2)
    black = ((x.long() + y.long()) % 2) == 0
    depth = geo.depth_from_plane(cam, state.planes, x, y)
    normal_world = geo.normal_cam_to_world(cam, state.planes[..., :3])
    for mask in (black, ~black):
        depth = checkerboard_median(depth, state.costs, x, y, cam.width,
                                    cam.height, mask, params)
    return SolverOutputs(depth=depth, normal_world=normal_world,
                         cost=state.costs, pre_costs=state.pre_costs)


def one_view(fn, *args):
    """`fn`, a solver function of a batch (run_patchmatch_batch,
    init_state, sweep_once, finalize), on one view: its SolverInputs and
    SolverState arguments become batches of one (zero-copy views), its Key
    a KeyBatch of one, and the result is view 0 of fn's."""
    def lift(a):
        if isinstance(a, (SolverInputs, SolverState)):
            return batch_of_one(a)
        if isinstance(a, keys.Key):
            return keys.stack([a])
        return a
    return view_of(fn(*(lift(a) for a in args)), 0)


def run_patchmatch_members(batches: Sequence[SolverInputs],
                           keys_list: Sequence[keys.KeyBatch],
                           params: PatchMatchParams,
                           mode: Mode = Mode()) -> List[SolverOutputs]:
    """Full PatchMatch solves of several batches in `mode`, each on the
    device of its inputs (the members of a device mesh,
    parallel/sharding.py), advanced in lock-step from this one host
    thread: every batch's context (whose true view counts are the solve's
    one host read) is built before the first launch, then each stage
    (init, half-sweep s, finalize) is issued for every batch before the
    next, so the queues of several cards overlap. Each batch's outputs
    are those of its own run_patchmatch_batch."""
    for inputs, kb in zip(batches, keys_list):
        if len(kb) != inputs.ref_img.shape[0]:
            raise ValueError(f"{len(kb)} keys for a batch of "
                             f"{inputs.ref_img.shape[0]} views")
    if len(batches) != len(keys_list):
        raise ValueError(f"{len(batches)} batches and {len(keys_list)} "
                         f"key batches")
    ctxs = [_context(inputs, params, mode) for inputs in batches]
    split = [keys.split(kb) for kb in keys_list]
    states = [_init_state(inputs, ctx.params, mode, k_init, ctx)
              for inputs, ctx, (k_init, _) in zip(batches, ctxs, split)]
    for s in range(2 * params.max_iterations):
        states = [_sweep(state, inputs, ctx, s % 2, s // 2,
                         keys.fold_in(k_sweeps, s), ctx.params, mode)
                  for state, inputs, ctx, (_, k_sweeps)
                  in zip(states, batches, ctxs, split)]
    return [finalize(state, inputs, ctx.params)
            for state, inputs, ctx in zip(states, batches, ctxs)]


def run_patchmatch_batch(inputs: SolverInputs, keys_b: keys.KeyBatch,
                         params: PatchMatchParams,
                         mode: Mode = Mode()) -> SolverOutputs:
    """Full PatchMatch solves of a batch of B reference views of one
    shape in `mode` (inputs with a leading [B], one key per view), on the
    device of `inputs`: one init, 2*max_iterations half-sweeps and one
    finalize for the whole batch, so the batch issues the launches of one
    solve. Keys follow the JAX package's batched executor per view:
    ``k_init, k_sweeps = split(key)`` and sweep s uses ``fold_in(k_sweeps,
    s)``, iteration s // 2, parity s % 2. Returns the batch's outputs,
    each view's those of its own run_patchmatch."""
    return run_patchmatch_members([inputs], [keys_b], params, mode)[0]


def run_patchmatch(inputs: SolverInputs, key: keys.Key,
                   params: PatchMatchParams,
                   mode: Mode = Mode()) -> SolverOutputs:
    """One full PatchMatch solve for one reference view in `mode`, on the
    device of `inputs` (a host loop: init, 2*max_iterations half-sweeps,
    finalize): run_patchmatch_batch of the batch of one."""
    return one_view(run_patchmatch_batch, inputs, key, params, mode)
