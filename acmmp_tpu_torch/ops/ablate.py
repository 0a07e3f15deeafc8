"""Plain PyTorch versions of the ZNCC ablation modes: what
csrc/ablate.cu computes for each mode, and what it is held against.

The JAX package's ``tools/prop_ablate.py`` times a replica of its TPU
K-stack kernel with parts of the work switched off, to find where the
kernel's time goes. csrc/zncc.cu is shaped differently: it has no row
scan and no bounding boxes, only a per-tap placement (homography step,
reciprocal, NaN guard, clamps, floors; ``place`` in csrc/zncc_tap.cuh),
one 2x2 word gather, and the bilinear, centring and moment arithmetic of
the tap loop. So each mode keeps the TPU tool's name, so that a reader
can find its counterpart, and takes the meaning that asks the same
question of zncc.cu's structure:

  first     zncc.cu's first design, frozen: the same costs as full,
            computed another way (four byte reads per tap); its plain
            version is full's.
  full      zncc.cu K = 8 as it is (TPU: the shipped kernel).
  noext     placement and the word gather per tap kept; no bilinear
            weights, centring or moments: s_src += w_t * (v00 + v01 + v10
            + v11). The centre sample c_src is still taken and seeds
            s_src2, which no tap updates, so that only per-tap work is
            removed; the final block as in full (TPU: no extraction,
            bilinear or ZNCC per tap; raw gathered words summed).
  nobounds  the placement only at tap 0 of each hypothesis; tap t reads at
            tap 0's integer corner + (di_t - di_0, dj_t - dj_0), clamped
            to the view, with tap 0's fractions (TPU: per-tap bounding-box
            reductions only at tap 0).
  noscan    no gather: every sample is 0; the placement stays live
            through a 1e-30 leak into the output of the sum of the word
            offsets (y0 * Ws + x0) of the centre read and every tap's, one
            sum per (hypothesis, pixel, view) (TPU: scan trip count 0,
            bounds kept live by the same leak).
  f32take   full, reading the sources widened to f32 (TPU: gathers on
            f32-bitcast words); bitwise equal to full.

So full - noscan is the gather, full - noext the bilinear, centring and
moment arithmetic, full - nobounds the per-tap placement, and f32take -
full the cost of 16-byte f32 quads against 32-bit words of bytes. Every
function takes parity-packed planes [K, Hg, W, 4] and returns [K, Hg, W,
V], the port's ZNCC layout.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.ops import ncc as ncc_ops
from acmmp_tpu_torch.ops import parity

MODES = ("first", "full", "noext", "nobounds", "noscan", "f32take")
# noscan's leak per unit of summed read offset (prop_ablate.py:337-344)
LEAK = 1e-30

# Parameters under which a mode's costs rest on the sums it keeps. At the
# shipped min_var and cost_max they do not: noext's s_src sums four raw
# values per tap, so var_src = s_src2 / sum_w - mean_src^2 is negative on
# every pixel and every cost is cost_max; noscan's leak (below 1e-22 at
# 1600x1184) is under f32's resolution at cost_max. With no variance
# floor and no cap, noext's cost is clip(1 + mean_ref * mean_src / 1e-15,
# 0, inf), linear in s_src wherever mean_ref > 0; with cost_max = 0,
# noscan's cost is its leak.
EXPOSING = {"noext": {"min_var": -math.inf, "cost_max": math.inf},
            "noscan": {"cost_max": 0.0}}


def widen_sources(src_imgs: torch.Tensor) -> torch.Tensor:
    """The 8-bit sources the kernel reads (cuda_ncc.prepare), widened to
    f32: f32take's sources."""
    return torch.round(torch.clamp(src_imgs, 0.0, 255.0)).to(
        torch.uint8).to(torch.float32)


def ablate_packed(mode: str, ref_img, src_imgs, vg: ncc_ops.ViewGeometry,
                  planes, params: PatchMatchParams, off0: int):
    """The plain version of `mode` on the parity-packed half grid:
    planes [K, H // 2, W, 4] -> costs [K, H // 2, W, V]."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode in ("first", "full", "f32take"):
        src = widen_sources(src_imgs) if mode == "f32take" else src_imgs
        return ncc_ops.multiview_zncc_packed(
            ref_img, src, vg, planes,
            dataclasses.replace(params, ncc_backend="plain"), off0)
    sums, in_bounds, leak = source_sums(mode, ref_img, src_imgs, vg, planes,
                                        params, off0)
    return ncc_ops.zncc_from_sums(*sums, in_bounds, params) + leak


def exposing_params(mode: str,
                    params: PatchMatchParams) -> PatchMatchParams:
    """`params` with EXPOSING[mode]'s min_var and cost_max."""
    return dataclasses.replace(params, **EXPOSING[mode])


def exposed_agreement(got: torch.Tensor, want: torch.Tensor,
                      rtol: float = 1e-5):
    """How closely costs `got` follow the plain `want` under exposing
    params: (share of the informative costs within rtol of want, relative
    to the larger of the two; share of the costs that are informative;
    largest relative difference among them). A cost is informative where
    either version gives a finite value other than 0 and 1 (there it is
    linear in noext's s_src, or it is noscan's leak), or where one is
    infinite (out of bounds) and the other not, which counts as outside."""
    fin_g, fin_w = torch.isfinite(got), torch.isfinite(want)

    def carries(x, fin):
        return fin & (x != 0.0) & (x != 1.0)

    info = carries(got, fin_g) | carries(want, fin_w) | (fin_g != fin_w)
    both = fin_g & fin_w
    rel = torch.where(
        both, (got - want).abs() / torch.maximum(got.abs(), want.abs()),
        math.inf)[info]
    if rel.numel() == 0:
        return 0.0, 0.0, math.inf
    return ((rel <= rtol).float().mean().item(),
            info.float().mean().item(), rel.max().item())


def source_sums(mode: str, ref_img, src_imgs, vg: ncc_ops.ViewGeometry,
                planes, params: PatchMatchParams, off0: int):
    """The moments a mode hands to the final block, its centre bounds
    test and its leak: ((sum_w, sum_ref, sum_ref_ref, s_src, s_src2,
    s_rs), in_bounds, leak) for mode noext, nobounds or noscan."""
    H, W = ref_img.shape
    dev = ref_img.device
    x, y = ncc_ops._grid(H, W, None, dev)
    pk = lambda a: parity.pack_rows(a, off0)            # noqa: E731
    ref_center = pk(ref_img)
    warp = ncc_ops.warper(pk(x), pk(y), vg, planes)
    sw, sh = vg.src_width, vg.src_height
    Ws = src_imgs.shape[2]
    xi_max = (sw - 1.0).long()
    yi_max = (sh - 1.0).long()
    taps = ncc_ops.tap_weights_spatial(params)
    inv_2sc2 = 1.0 / (2.0 * params.sigma_color ** 2)

    cx, cy = warp(0.0, 0.0)
    in_bounds = (cx >= 0.0) & (cx < sw) & (cy >= 0.0) & (cy < sh)
    if mode != "noscan":
        c_src = ncc_ops.sample_views(src_imgs, cx, cy, sw, sh)

    def read_offset(sx, sy):
        # the offset of the 2x2 word a read would gather (ablate.cu's
        # y0 * Ws + x0 within the view)
        x0, y0, _, _, _, _ = ncc_ops.place_views(sx, sy, sw, sh)
        return y0 * Ws + x0

    if mode == "noscan":
        offsets = read_offset(cx, cy)       # the centre sample's word
    elif mode == "nobounds":
        di0, dj0, _ = taps[0]
        x00, y00, _, _, fx, fy = ncc_ops.place_views(
            *warp(float(di0), float(dj0)), sw, sh)

    sum_ref = sum_ref_ref = sum_w = 0.0
    s_src = s_src2 = s_rs = torch.zeros(planes.shape[:-1] + (len(sw),),
                                        device=dev)
    if mode == "noext":
        s_src2 = c_src
    for di, dj, w_spatial in taps:
        ref_c = pk(ncc_ops._shift_edge(ref_img, dj, di)) - ref_center
        weight = w_spatial * torch.exp(-torch.abs(ref_c) * inv_2sc2)
        ref_c, weight = ref_c[..., None], weight[..., None]
        sum_ref = sum_ref + weight * ref_c
        sum_ref_ref = sum_ref_ref + weight * ref_c * ref_c
        sum_w = sum_w + weight
        if mode == "noscan":
            # the samples are 0, so are the moments
            offsets = offsets + read_offset(*warp(float(di), float(dj)))
            continue
        if mode == "noext":
            x0, y0, x1, y1, _, _ = ncc_ops.place_views(
                *warp(float(di), float(dj)), sw, sh)
            v00, v01, v10, v11 = ncc_ops.gather_views(src_imgs, x0, y0, x1,
                                                      y1)
            s_src = s_src + weight * (v00 + v01 + v10 + v11)
            continue
        # nobounds: tap 0's corner stepped by the tap offset, clamped
        x0 = torch.minimum(torch.clamp(x00 + (di - di0), min=0), xi_max)
        y0 = torch.minimum(torch.clamp(y00 + (dj - dj0), min=0), yi_max)
        x1 = torch.minimum(x0 + 1, xi_max)
        y1 = torch.minimum(y0 + 1, yi_max)
        src_c = ncc_ops.bilinear(
            *ncc_ops.gather_views(src_imgs, x0, y0, x1, y1), fx, fy) - c_src
        s_src = s_src + weight * src_c
        s_src2 = s_src2 + weight * src_c * src_c
        s_rs = s_rs + weight * ref_c * src_c

    leak = 0.0
    if mode == "noscan":
        # one unsigned 32-bit sum per (hypothesis, pixel, view) over its
        # reads, as the kernel's thread keeps it
        acc = torch.remainder(offsets, 2 ** 32)
        leak = LEAK * acc.to(torch.float32)
    return (sum_w, sum_ref, sum_ref_ref, s_src, s_src2, s_rs), in_bounds, leak
