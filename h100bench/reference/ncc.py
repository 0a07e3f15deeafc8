"""[The benchmark's plain reference: a frozen copy of the program's
`acmmp_tpu_torch/ops/ncc.py`, its plain (non-kernel) path only, importing
nothing of the program. Its original text follows.]

Bilateral-weighted ZNCC photometric cost — the port of
``acmmp_tpu/ops/ncc.py``.

``multiview_zncc`` / ``multiview_zncc_packed`` dispatch by device
(``PatchMatchParams.ncc_backend``): CUDA tensors go through the
hand-written kernel (ops/cuda_ncc.py, csrc/zncc.cu); CPU tensors, or
``ncc_backend="plain"``, go through the plain PyTorch version below,
``_zncc_grids``, which follows the JAX package's oracle step for step,
except that it accumulates centred moments (see there), and is what the
kernel is held against. There is no fallback: a CUDA tensor
with ``ncc_backend="cuda"`` or ``"auto"`` launches the kernel or raises,
and ``"cuda"`` on CPU tensors raises.

Sampling semantics match the reference's CUDA textures: float coordinate x
interpolates pixels floor(x)..floor(x)+1; out-of-window taps clamp to the
true image bounds (DEVIATIONS.md).

A batch of B reference views runs as one call: ref_img [B, H, W],
src_imgs [B, V, Hs, Ws], the ViewGeometry of the B views
(``make_view_geometry`` of [B] and [B, V] cameras) and candidate-major
planes [K, B, Hg, W, 4] (or [B, Hg, W, 4]) give [K, B, Hg, W, V] (or
[B, Hg, W, V]) costs, each view's those of its own call.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from h100bench.reference.params import PatchMatchParams
from h100bench.reference import geometry as geo
from h100bench.reference import parity

BACKENDS = ("auto", "plain", "cuda")


class ViewGeometry(NamedTuple):
    """Precomputed per-source-view homography constants and bounds; a
    batch's carry a leading [B]."""

    A: torch.Tensor           # [(B,) V, 3, 3]
    B: torch.Tensor           # [(B,) V, 3]
    KrT: torch.Tensor         # [(B,) 3, 3] (ref K^{-T}, shared by views)
    src_width: torch.Tensor   # [(B,) V]
    src_height: torch.Tensor  # [(B,) V]


def make_view_geometry(ref_cam: geo.Camera,
                       src_cams: geo.Camera) -> ViewGeometry:
    """src_cams: stacked Camera with leading view axis [V]; or a batch,
    ref_cam [B] and src_cams [B, V]."""
    nb = ref_cam.t.ndim - 1                # 1 for a batch, else 0
    A, B, KrT = geo.homography_coeffs(geo.insert_dims(ref_cam, nb, 1),
                                      src_cams)
    return ViewGeometry(A=A, B=B, KrT=KrT[..., 0, :, :],
                        src_width=src_cams.width,
                        src_height=src_cams.height)


def batch_dims(vg: ViewGeometry):
    """The leading batch dims of `vg`: () for one view, (B,) for a
    batch."""
    return tuple(vg.KrT.shape[:-2])


def tap_weights_spatial(params: PatchMatchParams):
    """Static per-tap spatial bilateral factors exp(-sqrt(i^2+j^2)/(2 s^2))
    (ComputeBilateralWeight, ACMMP.cu:353-358)."""
    taps = []
    for di in params.tap_offsets:
        for dj in params.tap_offsets:
            sd = math.sqrt(di * di + dj * dj)
            taps.append((di, dj, math.exp(-sd / (2.0 * params.sigma_spatial ** 2))))
    return taps


def multiview_zncc(ref_img, src_imgs, vg: ViewGeometry, planes,
                   params: PatchMatchParams, origin=None, n_views=None,
                   prep=None) -> torch.Tensor:
    """Per-view bilateral ZNCC costs for each plane hypothesis field.

    ref_img [H, W] and src_imgs [V, Hs, Ws] are edge-padded; planes is
    [K, H, W, 4] or [H, W, 4]. Returns [..., H, W, V] costs in
    [0, cost_max]; out-of-bounds centres and degenerate patches get
    cost_max (ACMMP.cu:368-369, 423-425). `n_views` is the true view
    count (a host int; for a batch, a sequence of B host ints): the
    kernel writes cost_max for padded slots without
    scoring them; the plain version scores them and callers mask them.
    `prep` is the kernel's per-solve preparation (cuda_ncc.prepare)."""
    H, W = ref_img.shape[-2:]
    x, y = _grid(H, W, origin, ref_img.device)
    tap_values = [shift_edge_hw(ref_img, dj, di)
                  for di, dj, _w in tap_weights_spatial(params)]
    return _zncc_grids(ref_img, tap_values, x, y, src_imgs, vg, planes, params)


def multiview_zncc_packed(ref_img, src_imgs, vg: ViewGeometry, planes,
                          params: PatchMatchParams, off0: int, origin=None,
                          n_views=None, prep=None) -> torch.Tensor:
    """`multiview_zncc` on a parity row-packed half grid (ops/parity.py):
    packed (i, j) is the full-grid pixel at local row 2i + (off0+j)%2.
    planes is [..., H//2, W, 4]; returns [..., H//2, W, V]."""
    H, W = ref_img.shape[-2:]
    x, y = _grid(H, W, origin, ref_img.device)
    pk = lambda a: parity.pack_rows(a, off0)            # noqa: E731
    tap_values = [pk(shift_edge_hw(ref_img, dj, di))
                  for di, dj, _w in tap_weights_spatial(params)]
    return _zncc_grids(pk(ref_img), tap_values, pk(x), pk(y), src_imgs, vg,
                       planes, params)


def _grid(H, W, origin, device):
    x, y = geo.pixel_grid(H, W, device=device)
    if origin is not None:
        y = y + origin[0]
        x = x + origin[1]
    return x, y


def sample_views(src_imgs, sx, sy, sw, sh):
    """Bilinear read of view v's image at (sx, sy)[..., v], clamped to the
    true extent (sw, sh)[v] — geometry.bilinear_sample per view, with the
    NaN guard of the kernel (a NaN coordinate reads pixel 0, as in
    pallas_ncc.py:324-325; the JAX oracle would read garbage there)."""
    x0, y0, x1, y1, fx, fy = place_views(sx, sy, sw, sh)
    return bilinear(*gather_views(src_imgs, x0, y0, x1, y1), fx, fy)


def bilinear(v00, v01, v10, v11, fx, fy):
    """The bilinear blend of the corners (y0, x0), (y0, x1), (y1, x0),
    (y1, x1) at fractions (fx, fy)."""
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def place_views(sx, sy, sw, sh):
    """sample_views' placement: the integer corners (x0, y0, x1, y1) and
    the fractions (fx, fy) of (sx, sy)[..., v] clamped to (sw, sh)[v]."""
    w_max = sw - 1.0
    h_max = sh - 1.0
    sx = torch.minimum(torch.clamp(torch.nan_to_num(sx, nan=0.0), min=0.0),
                       w_max)
    sy = torch.minimum(torch.clamp(torch.nan_to_num(sy, nan=0.0), min=0.0),
                       h_max)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0 = x0.long()
    y0 = y0.long()
    x1 = torch.minimum(x0 + 1, w_max.long())
    y1 = torch.minimum(y0 + 1, h_max.long())
    return x0, y0, x1, y1, fx, fy


def gather_views(src_imgs, x0, y0, x1, y1):
    """View v's pixels (y0, x0), (y0, x1), (y1, x0), (y1, x1) at the
    integer positions [..., v]; for a batch, src_imgs [B, V, Hs, Ws] and
    positions [..., B, Hg, W, V]."""
    Hs, Ws = src_imgs.shape[-2:]
    lead = src_imgs.shape[:-3]
    base = (torch.arange(src_imgs[..., 0, 0].numel(), device=src_imgs.device)
            * (Hs * Ws)).reshape(lead + (1, 1, src_imgs.shape[-3]))
    flat = src_imgs.reshape(-1)
    r0 = base + y0 * Ws
    r1 = base + y1 * Ws
    return (take(flat, r0 + x0), take(flat, r0 + x1), take(flat, r1 + x0),
            take(flat, r1 + x1))


def take(flat, idx):
    """flat[idx] for a 1-D `flat` and non-negative int64 `idx`, through
    index_select: the same values, several times faster on the CPU than
    advanced indexing."""
    return flat.index_select(0, idx.reshape(-1)).reshape(idx.shape)


def warper(x, y, vg: ViewGeometry, planes):
    """warp(di, dj) -> (sx, sy), each [..., *grid, V]: tap (di, dj) of
    every pixel of the grid (x, y) through each hypothesis' plane-induced
    homography into every view. `planes` is [..., *grid, 4]
    ([..., B, *grid, 4] for a batch's `vg`)."""
    # the batch axis, if any, broadcasts against the grid's leading axis
    lead = batch_dims(vg) + (1, 1)
    KrT = vg.KrT.reshape(lead + (3, 3))
    A = vg.A.reshape(lead + vg.A.shape[-3:])        # [*lead, V, 3, 3]
    B = vg.B.reshape(lead + vg.B.shape[-2:])        # [*lead, V, 3]
    # rank-1 homography piece per hypothesis: m = Kr^{-T} n, [..., *grid, 3]
    m = geo.matvec(KrT, planes[..., :3])
    inv_w = 1.0 / planes[..., 3]
    m0, m1, m2 = m[..., 0, None], m[..., 1, None], m[..., 2, None]
    inv_w = inv_w[..., None]
    xv, yv = x[..., None], y[..., None]

    def warp(di, dj):
        # pt = (A q) - B * (m . q) / w  (homogeneous), q = (x+di, y+dj, 1)
        qx = xv + di
        qy = yv + dj
        aq0 = A[..., 0, 0] * qx + A[..., 0, 1] * qy + A[..., 0, 2]
        aq1 = A[..., 1, 0] * qx + A[..., 1, 1] * qy + A[..., 1, 2]
        aq2 = A[..., 2, 0] * qx + A[..., 2, 1] * qy + A[..., 2, 2]
        mq = (m0 * qx + m1 * qy + m2) * inv_w
        px = aq0 - B[..., 0] * mq
        py = aq1 - B[..., 1] * mq
        pz = aq2 - B[..., 2] * mq
        return px / pz, py / pz

    return warp


def zncc_from_sums(sum_w, sum_ref, sum_ref_ref, sum_src, sum_src_src,
                   sum_ref_src, in_bounds, params: PatchMatchParams):
    """The ZNCC cost from the bilateral-weighted moments: clip(1 - covar /
    sqrt(max(var_ref * var_src, 1e-30)), 0, cost_max), cost_max where a
    variance is below min_var or the centre is out of bounds."""
    cost_max = params.cost_max
    inv_sum_w = 1.0 / sum_w
    mean_ref = sum_ref * inv_sum_w
    mean_src = sum_src * inv_sum_w
    var_ref = sum_ref_ref * inv_sum_w - mean_ref * mean_ref
    var_src = sum_src_src * inv_sum_w - mean_src * mean_src
    covar = sum_ref_src * inv_sum_w - mean_ref * mean_src
    denom = torch.sqrt(torch.clamp(var_ref * var_src, min=1e-30))
    ncc = torch.clamp(1.0 - covar / denom, 0.0, cost_max)
    degenerate = (var_ref < params.min_var) | (var_src < params.min_var)
    cost = torch.where(degenerate, cost_max, ncc)
    return torch.where(in_bounds, cost, cost_max)


def _zncc_grids(ref_center, tap_values, x, y, src_imgs, vg, planes, params):
    """The plain ZNCC over explicit coordinate grids, all V views at once
    (views on the last axis). `ref_center`/`tap_values` and `x`/`y` share
    a grid shape (full image or parity-packed half grid); `planes` is
    [..., *grid, 4]; returns [..., *grid, V]. For a batch the reference
    side is [B, *grid] and planes [..., B, *grid, 4]."""
    warp = warper(x, y, vg, planes)
    lead = batch_dims(vg) + (1, 1)
    sw = vg.src_width.reshape(lead + vg.src_width.shape[-1:])
    sh = vg.src_height.reshape(lead + vg.src_height.shape[-1:])
    # centre bounds check (ACMMP.cu:367-370): pt at the pixel itself
    cx, cy = warp(0.0, 0.0)
    in_bounds = (cx >= 0.0) & (cx < sw) & (cy >= 0.0) & (cy < sh)

    # The moments run over centred values: reference taps minus the
    # reference pixel's value, source samples minus the source sample at
    # the centre warp. The ZNCC is shift-invariant, and centring keeps the
    # one-pass variance E[v^2] - E[v]^2 well conditioned in f32 for the
    # smooth 8-bit patches of high-resolution views (uncentred, v^2 ~ 4e4
    # against variances below 1; see csrc/zncc.cu).
    inv_2sc2 = 1.0 / (2.0 * params.sigma_color ** 2)
    c_src = sample_views(src_imgs, cx, cy, sw, sh)
    sum_ref = sum_ref_ref = sum_src = sum_src_src = sum_ref_src = 0.0
    sum_w = 0.0
    for t, (di, dj, w_spatial) in enumerate(tap_weights_spatial(params)):
        ref_c = tap_values[t] - ref_center
        weight = w_spatial * torch.exp(-torch.abs(ref_c) * inv_2sc2)
        sx, sy = warp(float(di), float(dj))
        src_c = sample_views(src_imgs, sx, sy, sw, sh) - c_src
        ref_c, weight = ref_c[..., None], weight[..., None]
        if params.zncc_dtype != "float32":
            # the control: the moments in a lower precision
            dt = getattr(torch, params.zncc_dtype)
            ref_c, weight, src_c = ref_c.to(dt), weight.to(dt), src_c.to(dt)
        sum_ref = sum_ref + weight * ref_c
        sum_ref_ref = sum_ref_ref + weight * ref_c * ref_c
        sum_src = sum_src + weight * src_c
        sum_src_src = sum_src_src + weight * src_c * src_c
        sum_ref_src = sum_ref_src + weight * ref_c * src_c
        sum_w = sum_w + weight
    return zncc_from_sums(sum_w, sum_ref, sum_ref_ref, sum_src, sum_src_src,
                          sum_ref_src, in_bounds, params).float()


def shift_edge_hw(img: torch.Tensor, dj: int, di: int) -> torch.Tensor:
    """img [..., H, W] shifted so out[..., y, x] = img[..., clamp(y+dj),
    clamp(x+di)] (leading batch axes are kept)."""
    H, W = img.shape[-2:]
    rows = torch.clamp(torch.arange(H, device=img.device) + dj, 0, H - 1)
    cols = torch.clamp(torch.arange(W, device=img.device) + di, 0, W - 1)
    return img[..., rows, :][..., cols]


def _shift_edge(img: torch.Tensor, dj: int, di: int) -> torch.Tensor:
    """img [H, W, ...] shifted so out[y, x] = img[clamp(y+dj), clamp(x+di)]
    (trailing channel axes are kept)."""
    H, W = img.shape[:2]
    rows = torch.clamp(torch.arange(H, device=img.device) + dj, 0, H - 1)
    cols = torch.clamp(torch.arange(W, device=img.device) + di, 0, W - 1)
    return img[rows][:, cols]


def initial_cost_and_views(costs: torch.Tensor, view_mask: torch.Tensor,
                           params: PatchMatchParams):
    """Top-k averaging + selected-view mask
    (ComputeMultiViewInitialCostandSelectedViews, ACMMP.cu:434-471).
    costs [..., H, W, V], view_mask broadcastable to it ([V], or
    [B, 1, 1, V] for a batch); returns (cost [..., H, W], selected
    [..., H, W, V] bool)."""
    masked = torch.where(view_mask, costs, 1e9)
    valid = masked < params.cost_max
    num_valid = valid.sum(-1)                                 # [H, W]
    sorted_costs = torch.sort(masked, dim=-1).values          # ascending
    top_k = torch.clamp(num_valid, max=params.top_k)          # [H, W]
    idx = torch.arange(costs.shape[-1], device=costs.device)
    take = idx < top_k[..., None]
    cost_sum = torch.where(take, sorted_costs, 0.0).sum(-1)
    cost = torch.where(top_k > 0,
                       cost_sum / torch.clamp(top_k, min=1).to(costs.dtype),
                       params.cost_max)
    # threshold = k-th smallest cost; views at or below it are selected
    kth = torch.gather(sorted_costs, -1,
                       torch.clamp(top_k - 1, min=0)[..., None])[..., 0]
    selected = (masked <= kth[..., None]) & (top_k[..., None] > 0) & view_mask
    return cost, selected
