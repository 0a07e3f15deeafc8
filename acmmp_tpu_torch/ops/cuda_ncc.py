"""Wrapper of the warped bilateral-ZNCC CUDA kernel (csrc/zncc.cu).

The kernel stands in for the JAX package's two Pallas kernels,
``multiview_zncc_pallas`` (K = 1) and ``_kshared_call`` (K-stacks), and is
held against the plain version in ops/ncc.py. The wrapper does the
reference-side preparation the JAX package does in jnp outside Pallas
(``_ref_side``, pallas_ncc.py:67-87) in plain PyTorch, checks what it is
given, allocates the output, launches on the current stream and raises if
the launch failed. There is no fallback: a tensor the kernel does not
take raises.

``prepare`` does the per-solve part once (u8 sources, homography
constants, tap offsets, reference-side weights for one grid layout), so a
solve's 13 launches repeat none of it."""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.kernels import check_arg, hypothesis_stack
from acmmp_tpu_torch.ops import ncc as ncc_ops
from acmmp_tpu_torch.ops import parity

SUPPORTED_K = (1, 2, 3, 8)
_HEADER = 16        # consts floats before the per-view block (K^{-T})
_VIEW_STRIDE = 16   # consts floats per view: A (9), B (3), width, height

# launches of the kernel by K; the wrapper adds one where it launches and
# nowhere else
launches = {k: 0 for k in SUPPORTED_K}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def total_launches() -> int:
    return sum(launches.values())


class ZnccPrep(NamedTuple):
    """Per-solve inputs of the kernel for one grid layout."""

    src_u8: torch.Tensor     # [V, Hs, Ws] uint8
    consts: torch.Tensor     # [16 + 16 V] f32: K^{-T}, then A, B, w, h per view
    taps: torch.Tensor       # [T, 2] f32 (di, dj)
    w_taps: torch.Tensor     # [T, Hg, W] bilateral weights
    wr_taps: torch.Tensor    # [T, Hg, W] weights x centred reference taps
    refsums: torch.Tensor    # [3, Hg, W] sum_w, sum_ref, sum_ref^2
    row_pack_off: int        # -1: full grid, else the parity offset off0


def ref_side(ref_img: torch.Tensor, params: PatchMatchParams):
    """Per-tap reference weights and the reference-side ZNCC sums
    (``_ref_side``, pallas_ncc.py:67-87), on the full grid, over reference
    values centred on each pixel's own value (ops/ncc.py _zncc_grids).
    Returns (w [T, H, W], w * (ref_tap - ref) [T, H, W],
    [sum_w, sum_ref, sum_ref^2] [3, H, W])."""
    inv_2sc2 = 1.0 / (2.0 * params.sigma_color ** 2)
    w_list, wr_list = [], []
    sum_w = sum_ref = sum_ref_ref = 0.0
    for di, dj, w_spatial in ncc_ops.tap_weights_spatial(params):
        ref_c = ncc_ops._shift_edge(ref_img, dj, di) - ref_img
        w = w_spatial * torch.exp(-torch.abs(ref_c) * inv_2sc2)
        w_list.append(w)
        wr_list.append(w * ref_c)
        sum_w = sum_w + w
        sum_ref = sum_ref + w * ref_c
        sum_ref_ref = sum_ref_ref + w * ref_c * ref_c
    return (torch.stack(w_list), torch.stack(wr_list),
            torch.stack([sum_w, sum_ref, sum_ref_ref]))


def prepare(ref_img: torch.Tensor, src_imgs: torch.Tensor,
            vg: ncc_ops.ViewGeometry, params: PatchMatchParams,
            row_pack_off: Optional[int] = None) -> ZnccPrep:
    """The kernel's per-solve inputs for one layout (full grid when
    `row_pack_off` is None, else the parity-packed half grid)."""
    if not params.ncc_src_u8:
        raise NotImplementedError(
            "the ZNCC kernel reads 8-bit sources (ncc_src_u8=True); use "
            "ncc_backend='plain' for float sources")
    dev = ref_img.device
    src_u8 = torch.round(torch.clamp(src_imgs, 0.0, 255.0)).to(torch.uint8)
    V = src_imgs.shape[0]
    consts = torch.zeros(_HEADER + _VIEW_STRIDE * V, dtype=torch.float32,
                         device=dev)
    consts[:9] = vg.KrT.reshape(9)
    per_view = consts[_HEADER:].view(V, _VIEW_STRIDE)
    per_view[:, :9] = vg.A.reshape(V, 9)
    per_view[:, 9:12] = vg.B
    per_view[:, 12] = vg.src_width
    per_view[:, 13] = vg.src_height
    taps = torch.tensor([(float(di), float(dj)) for di, dj, _w
                         in ncc_ops.tap_weights_spatial(params)],
                        dtype=torch.float32, device=dev)
    w_taps, wr_taps, refsums = ref_side(ref_img, params)
    off = -1
    if row_pack_off is not None:
        off = int(row_pack_off)
        w_taps = parity.pack_rows(w_taps, off)
        wr_taps = parity.pack_rows(wr_taps, off)
        refsums = parity.pack_rows(refsums, off)
    return ZnccPrep(src_u8.contiguous(), consts, taps, w_taps.contiguous(),
                    wr_taps.contiguous(), refsums.contiguous(), off)


def _lib():
    from acmmp_tpu_torch.kernels import _build

    lib = _build.load("zncc")
    fn = lib.acmmp_zncc_launch
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [ci] + [vp] * 8 + [ci] * 7 + [cf, cf, ci, cf, cf, vp]
        fn.restype = ci
    return fn


def multiview_zncc_cuda(ref_img, src_imgs, vg: ncc_ops.ViewGeometry, planes,
                        params: PatchMatchParams, origin=None,
                        row_pack_off=None, n_views=None,
                        prep: Optional[ZnccPrep] = None) -> torch.Tensor:
    """Per-view ZNCC costs through the kernel: planes [K, Hg, W, 4] (or
    [Hg, W, 4]) -> [K, Hg, W, V] (or [Hg, W, V]); Hg = H, or H // 2 with
    parity packing (`row_pack_off` = off0). `n_views` is a host int."""
    planes, squeeze = hypothesis_stack("zncc", planes, SUPPORTED_K)
    K = planes.shape[0]
    H, W = ref_img.shape
    V, Hs, Ws = src_imgs.shape
    Hg = H if row_pack_off is None else H // 2
    if row_pack_off is not None and H % 2:
        raise ValueError("zncc kernel: parity packing needs an even height")
    dev = planes.device
    if prep is None:
        prep = prepare(ref_img, src_imgs, vg, params, row_pack_off)
    want_off = -1 if row_pack_off is None else int(row_pack_off)
    if prep.row_pack_off != want_off:
        raise ValueError(f"zncc kernel: prep is for row_pack_off="
                         f"{prep.row_pack_off}, call has {want_off}")
    T = prep.taps.shape[0]
    check_arg("zncc", "planes", planes, torch.float32, (K, Hg, W, 4), dev)
    check_arg("zncc", "src_u8", prep.src_u8, torch.uint8, (V, Hs, Ws), dev)
    check_arg("zncc", "consts", prep.consts, torch.float32,
              (_HEADER + _VIEW_STRIDE * V,), dev)
    check_arg("zncc", "taps", prep.taps, torch.float32, (T, 2), dev)
    check_arg("zncc", "w_taps", prep.w_taps, torch.float32, (T, Hg, W), dev)
    check_arg("zncc", "wr_taps", prep.wr_taps, torch.float32, (T, Hg, W), dev)
    check_arg("zncc", "refsums", prep.refsums, torch.float32, (3, Hg, W), dev)
    if planes.data_ptr() % 16:
        raise ValueError("zncc kernel: planes must be 16-byte aligned")
    if K * Hg * W * V >= 2 ** 31 or V * Hs * Ws >= 2 ** 31:
        raise ValueError("zncc kernel: problem too large for 32-bit indexing")
    nv = V if n_views is None else int(n_views)
    oy, ox = (0.0, 0.0) if origin is None else (float(origin[0]),
                                                float(origin[1]))

    out = torch.empty((K, Hg, W, V), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib()(K, planes.data_ptr(), prep.src_u8.data_ptr(),
                    prep.w_taps.data_ptr(), prep.wr_taps.data_ptr(),
                    prep.refsums.data_ptr(), prep.consts.data_ptr(),
                    prep.taps.data_ptr(), out.data_ptr(), V, nv, Hg, W, Hs,
                    Ws, T, oy, ox, prep.row_pack_off, float(params.cost_max),
                    float(params.min_var), stream)
    if rc != 0:
        raise RuntimeError(f"zncc kernel launch failed: cudaError {rc}")
    launches[K] += 1
    return out[0] if squeeze else out
