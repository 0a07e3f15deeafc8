"""Image-domain (row tile) sharding with halo exchange — the port of
``acmmp_tpu/parallel/tiles.py``, for single views too large for one
device's step.

The solver's stencil is bounded: the adaptive checkerboard propagation
reads at most 23 rows away (far strips reach 3 + 2*10,
src/ACMMP.cu:819-827), joint view selection reads the 4-adjacent
pixels' selections and the median filter a 5-px cross. So the image rows
split over the members of a tile mesh, each member keeping its rows plus
a HALO-row band of each neighbour's, refreshed before every half-sweep
(planes, costs, selected, the carried per-view costs). Halos move by
device copies (none on a repeated device) and, between members of
different processes, through the all-gather (parallel/multihost.py);
source images, cameras and depth maps are replicated read-only state.

Every solver mode is covered. The mode's row inputs (re-entry depth,
normal and cost, the prior planes and mask, seeded planes, hierarchy
pre-costs) shard with the image rows; the sweep reads them only at the
pixel itself, so zero halos are right for them. Each member's grid sits
at its tile origin (image coordinates): the parity, the counter-based
draws (keyed on global pixels, ops/pixel_rng.py, and on the windowed
law's global (16, 128) tiles) and both kernels (the origin of zncc.cu
and geom.cu) see the untiled solve's coordinates, and the reference's
outer halos replicate its border rows as the untiled solve's
edge-clamped taps do (DEVIATIONS.md #12). So the tiled solve is
bitwise equal to run_patchmatch (tests/test_torch_tiles.py,
chip_smoke.py phase 11b). Each process advances its own members in
lock-step from one host thread: every member's context is built before
the first launch, and each stage is issued for every member before the
next."""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.core import geometry as geo
from acmmp_tpu_torch.engine.patchmatch import (
    Mode, SolverInputs, SolverOutputs, SolverState, _check_mode, _Context,
    _sweep, batch_of_one, effective_params, init_planes, view_of,
)
from acmmp_tpu_torch.ops import keys
from acmmp_tpu_torch.ops import ncc as ncc_ops
from acmmp_tpu_torch.ops.median import checkerboard_median
from acmmp_tpu_torch.parallel.sharding import (Mesh, check_placement,
                                               gather_members, make_view_mesh,
                                               map_tensors)

HALO = 24  # >= the 23-px stencil reach, rounded to a multiple of 8

# per-pixel row fields: they shard with the image rows; the rest of
# SolverInputs is replicated
ROW_FIELDS = ("ref_img", "init_depth", "init_normal_world", "init_cost",
              "prior_planes", "prior_mask", "seed_planes", "pre_costs")


# a tile mesh is the same ordered list of devices as a view mesh
make_tile_mesh = make_view_mesh


def _exchange_halos(arrs: List[Optional[torch.Tensor]],
                    edge_replicate: bool = False,
                    mesh: Optional[Mesh] = None
                    ) -> List[Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """(top, bottom) halos of each member's row field ([B, rows, ...],
    rows on axis 1; None for the members of other processes, whose
    halos are None too): the last HALO rows of the member above and the
    first HALO rows of the member below, on the member's device. The
    bands cross `mesh` (by default the single-process mesh of the
    fields' devices) through gather_members. Edge members get zero halos
    (their pixels fail the true-bounds checks downstream), except with
    `edge_replicate`, which repeats the member's own first / last row:
    the reference image's halos must reproduce the untiled solve's
    edge-clamped taps (DEVIATIONS.md #12)."""
    n = len(arrs)
    if mesh is None:
        mesh = Mesh([a.device for a in arrs])
    bands = gather_members(mesh, {m: (a[:, :HALO], a[:, -HALO:])
                                  for m, a in enumerate(arrs)
                                  if a is not None})
    out = []
    for m, a in enumerate(arrs):
        if a is None:
            out.append(None)
            continue
        band = a[:, :HALO]
        if m > 0:
            top = bands[m - 1][1].to(a.device)
        elif edge_replicate:
            top = a[:, :1].expand_as(band)
        else:
            top = torch.zeros_like(band)
        if m < n - 1:
            bot = bands[m + 1][0].to(a.device)
        elif edge_replicate:
            bot = a[:, -1:].expand_as(band)
        else:
            bot = torch.zeros_like(band)
        out.append((top, bot))
    return out


def _ext(local, top, bot):
    return torch.cat([top, local, bot], dim=1)


def _zext(a):
    """`a` with HALO zero (False) rows above and below."""
    if a is None:
        return None
    halo = torch.zeros_like(a[:, :HALO])
    return _ext(a, halo, halo)


def _halo_ext(mesh: Mesh, fields: List[Optional[torch.Tensor]],
              edge_replicate: bool = False) -> List[Optional[torch.Tensor]]:
    """Each member's field extended by its neighbours' halos (None for
    other processes' members)."""
    return [None if a is None else _ext(a, *h) for a, h
            in zip(fields, _exchange_halos(fields, edge_replicate, mesh))]


def _core(a, rows: int):
    return a[:, HALO:HALO + rows]


def tile_sharded_patchmatch(mesh: Mesh, inputs: SolverInputs,
                            key: keys.Key, params: PatchMatchParams,
                            mode: Mode) -> SolverOutputs:
    """Full PatchMatch solve of ONE view with its image rows sharded over
    the mesh, in any solver mode; the result, on the device of `inputs`,
    is bitwise run_patchmatch's on the same inputs and key. H must be a
    multiple of 8 x the mesh size, and each member's rows at least
    HALO."""
    _check_mode(mode, inputs)
    H, W = inputs.ref_img.shape
    n = len(mesh)
    if H % (8 * n):
        raise ValueError(f"tile_sharded_patchmatch: height {H} is not a "
                         f"multiple of 8 x {n} members")
    rows = H // n
    if rows < HALO:
        raise ValueError(f"tile_sharded_patchmatch: tiles must be at least "
                         f"{HALO} rows tall (the halo reach); got {rows} "
                         f"rows per member")
    # shape-dependent gates resolve from the FULL image shape, as in
    # run_patchmatch (the members' shapes differ)
    params = effective_params(params, H, W)
    one = batch_of_one(inputs)
    shared = one._replace(**{f: None for f in ROW_FIELDS})
    local = mesh.local()
    members = [None] * n
    for m in local:
        band = slice(m * rows, (m + 1) * rows)
        members[m] = map_tensors(shared, lambda t: t.to(mesh[m]))._replace(
            **{f: getattr(one, f)[:, band].to(mesh[m]) for f in ROW_FIELDS
               if getattr(one, f) is not None})
    check_placement(mesh, [members[m] for m in local])

    def each(fn, *lists):
        """fn(m, *items) for this process's members, None for others'."""
        return [fn(m, *(x[m] for x in lists)) if m in local else None
                for m in range(n)]

    # the sweeps run on the halo-extended tiles: the reference with its
    # neighbours' rows (replicated at the image's outer edges), the prior
    # fields with zero halos (read only at the pixel itself)
    refs = _halo_ext(mesh, each(lambda m, mi: mi.ref_img, members),
                     edge_replicate=True)
    ext_inputs = each(lambda m, mi, ref: mi._replace(
        ref_img=ref, prior_planes=_zext(mi.prior_planes),
        prior_mask=_zext(mi.prior_mask)), members, refs)
    # every member's context (its one host read) before the first launch
    ctxs = each(lambda m, ei: _Context(ei, params, origin=(m * rows - HALO,
                                                           0)), ext_inputs)

    # ---- init on the members' own rows ----
    kb = keys.stack([key])
    k_init, k_sweeps = keys.split(kb)

    def init(m, mi, ctx):
        x, y = _core(ctx.x[None], rows)[0], _core(ctx.y[None], rows)[0]
        planes = init_planes(mi, params, mode, k_init, ctx.cam, x, y,
                             ctx.dmin, ctx.dmax)
        # the init's ZNCC on the extended reference, so that the ref taps
        # of a seam pixel read the true neighbour rows; the halo planes
        # (zeros) only give halo costs, which are dropped
        per_view = _core(ctx.zncc(_zext(planes)), rows)
        costs, selected = ncc_ops.initial_cost_and_views(
            per_view, ctx.view_mask, params)
        geom_pv = None
        if mode.geom_consistency:
            geom_pv = ctx.geom(planes[None], origin=(m * rows, 0))[0]
        pre = costs if mi.pre_costs is None else mi.pre_costs
        return SolverState(planes=planes, costs=costs, selected=selected,
                           pre_costs=pre, ncc_pv=per_view, geom_pv=geom_pv)
    states = each(init, members, ctxs)

    # ---- half-sweeps on the halo-extended tiles ----
    geom = mode.geom_consistency

    def field(name):
        return each(lambda m, st: getattr(st, name), states)
    for s in range(2 * params.max_iterations):
        planes = _halo_ext(mesh, field("planes"))
        cost_halos = _exchange_halos(field("costs"), mesh=mesh)
        selected = _halo_ext(mesh, field("selected"))
        ncc_pv = _halo_ext(mesh, field("ncc_pv"))
        geom_pv = _halo_ext(mesh, field("geom_pv")) if geom else [None] * n
        k = keys.fold_in(k_sweeps, s)

        def sweep(m, st, ctx, ei, ch):
            # the hierarchy gate's halo rows take the neighbours' costs,
            # as the JAX module's do (their outputs are dropped)
            ext = SolverState(planes=planes[m], costs=_ext(st.costs, *ch),
                              selected=selected[m],
                              pre_costs=_ext(st.pre_costs, *ch),
                              ncc_pv=ncc_pv[m], geom_pv=geom_pv[m])
            new = _sweep(ext, ei, ctx, s % 2, s // 2, k, params, mode)
            return SolverState(
                planes=_core(new.planes, rows), costs=_core(new.costs, rows),
                selected=_core(new.selected, rows), pre_costs=st.pre_costs,
                ncc_pv=_core(new.ncc_pv, rows),
                geom_pv=_core(new.geom_pv, rows) if geom else None)
        states = each(sweep, states, ctxs, ext_inputs, cost_halos)

    # ---- finalize: depth and cost halos for the two median passes ----
    def depth(m, st, ctx):
        x, y = _core(ctx.x[None], rows)[0], _core(ctx.y[None], rows)[0]
        return geo.depth_from_plane(ctx.cam, st.planes, x, y)
    depth_e = _halo_ext(mesh, each(depth, states, ctxs))
    cost_e = _halo_ext(mesh, field("costs"))

    def finish(m, d, c, st, ctx):
        for mask in (ctx.black, ~ctx.black):
            d = checkerboard_median(d, c, ctx.x, ctx.y, ctx.cam.width,
                                    ctx.cam.height, mask, params)
        return SolverOutputs(
            depth=_core(d, rows),
            normal_world=geo.normal_cam_to_world(ctx.cam, st.planes[..., :3]),
            cost=st.costs, pre_costs=st.pre_costs)
    outs = each(finish, depth_e, cost_e, states, ctxs)
    dev = inputs.ref_img.device
    got = gather_members(mesh, {m: outs[m] for m in local})
    return view_of(SolverOutputs(*(torch.cat([f.to(dev) for f in fs], dim=1)
                                   for fs in zip(*got))), 0)
