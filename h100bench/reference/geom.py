"""[The benchmark's plain reference: a frozen copy of the program's
`acmmp_tpu_torch/ops/geom.py`, its plain (non-kernel) path only, importing
nothing of the program. Its original text follows.]

Geometric-consistency cost — the port of ``acmmp_tpu/ops/geom.py``:
the forward-backward reprojection error of each plane hypothesis against
the source views' depth maps (ComputeGeomConsistencyCost,
src/ACMMP.cu:518-543), over the image grid, hypotheses and views.

``geom_consistency_cost`` dispatches like ``ops/ncc.py``
(``PatchMatchParams.ncc_backend``): CUDA tensors go through the
hand-written kernel (ops/cuda_geom.py, csrc/geom.cu); CPU tensors, or
``ncc_backend="plain"``, go through the plain version below. There is no
fallback: a CUDA tensor launches the kernel or raises.

The plain version keeps the JAX oracle's staged form (world_point ->
project -> nearest read -> world_point -> project) with the views on the
last axis, and takes the Pallas kernel's rule for NaN
(pallas_geom.py:129-130, 168): coordinates are made finite and clamped in
float before they are truncated, and a NaN error is geom_cost_max. For
finite coordinates that equals the oracle's truncate-then-clip.

A batch of B reference views runs as one call: ref_cam [B], src_cams
[B, V], src_depths [B, V, Hs, Ws] and candidate-major planes
[..., B, Hg, W, 4] give [..., B, Hg, W, V], each view's costs those of
its own call.
"""

from __future__ import annotations

import torch

from h100bench.reference.params import PatchMatchParams
from h100bench.reference import geometry as geo
from h100bench.reference import ncc as ncc_ops
from h100bench.reference import parity


def geom_consistency_cost(ref_cam: geo.Camera, src_cams: geo.Camera,
                          src_depths: torch.Tensor, planes: torch.Tensor,
                          params: PatchMatchParams, row_pack_off=None,
                          n_views=None, prep=None,
                          origin=None) -> torch.Tensor:
    """[..., Hg, W, V] clamped reprojection errors of `planes`
    [..., Hg, W, 4] against `src_depths` [V, Hs, Ws] (0 = invalid).

    The planes lie on the full pixel grid, or on its parity-packed half
    grid when `row_pack_off` (the host int off0) is given, of a tile whose
    pixel (0, 0) is image pixel `origin` (host ints (y0, x0); None for
    (0, 0): the whole image); both routes build that grid from the same
    three facts. `n_views`
    is the true view count (a host int; for a batch, a sequence of B host
    ints): the kernel writes geom_cost_max for
    padded slots without reading them; the plain version reads their zero
    depth maps, which gives the same. `prep` is the kernel's per-solve
    preparation (cuda_geom.prepare)."""
    x, y = plane_grid(planes, row_pack_off, origin)
    return _geom_plain(ref_cam, src_cams, src_depths, planes, x, y, params)


def plane_grid(planes: torch.Tensor, row_pack_off=None, origin=None):
    """The pixel grid (x, y) of `planes` [..., Hg, W, 4] in image
    coordinates: the full grid, or the rows of parity offset off0 of the
    [2 Hg, W] grid packed, shifted by the tile origin (y0, x0)."""
    Hg, W = planes.shape[-3:-1]
    rows = Hg if row_pack_off is None else 2 * Hg
    x, y = geo.pixel_grid(rows, W, device=planes.device)
    if origin is not None:
        y = y + float(origin[0])
        x = x + float(origin[1])
    if row_pack_off is None:
        return x, y
    return (parity.pack_rows(x, row_pack_off),
            parity.pack_rows(y, row_pack_off))


def _geom_plain(ref_cam, src_cams, src_depths, planes, x, y,
                params: PatchMatchParams) -> torch.Tensor:
    """The plain version, all V views at once on the last axis (a batch's
    cameras broadcast over the grid, geometry.insert_dims)."""
    max_cost = params.geom_cost_max
    nb = ref_cam.t.ndim - 1                # 1 for a batch, else 0
    ref_g = geo.insert_dims(ref_cam, nb, 2)
    src_g = geo.insert_dims(src_cams, nb, 2)
    depth = geo.depth_from_plane(ref_g, planes, x, y)          # [..., H, W]
    Xw = geo.world_point(ref_g, x, y, depth)                   # [..., H, W, 3]
    uv, _ = geo.project(src_g, Xw[..., None, :])               # [..., V, 2]
    u, v = uv[..., 0], uv[..., 1]
    sd = _nearest_views(src_depths, u, v, src_g.width, src_g.height)
    Xs = geo.world_point(src_g, u, v, sd)                      # [..., V, 3]
    buv, _ = geo.project(geo.insert_dims(ref_cam, nb, 3), Xs)
    err = torch.sqrt((x[..., None] - buv[..., 0]) ** 2
                     + (y[..., None] - buv[..., 1]) ** 2)
    err = torch.clamp(torch.nan_to_num(err, nan=max_cost), max=max_cost)
    return torch.where(sd <= 0.0, max_cost, err)


def _nearest_views(src_depths, u, v, sw, sh):
    """geometry.nearest_sample per view: view j's map read at
    (u, v)[..., j], clamped to its true extent (sw, sh)[j]; for a batch,
    src_depths [B, V, Hs, Ws] and (u, v) [..., B, H, W, V]."""
    Hs, Ws = src_depths.shape[-2:]
    lead = src_depths.shape[:-3]
    xi, yi = geo.nearest_index(src_depths, u, v, sw, sh)
    base = (torch.arange(src_depths[..., 0, 0].numel(),
                         device=src_depths.device)
            * (Hs * Ws)).reshape(lead + (1, 1, src_depths.shape[-3]))
    return ncc_ops.take(src_depths.reshape(-1), base + yi * Ws + xi)
