"""Wrapper of the warped bilateral-ZNCC CUDA kernel (csrc/zncc.cu).

The kernel stands in for the JAX package's two Pallas kernels,
``multiview_zncc_pallas`` (K = 1) and ``_kshared_call`` (K-stacks), and is
held against the plain version in ops/ncc.py. The wrapper does the
reference-side preparation the JAX package does in jnp outside Pallas
(``_ref_side``, pallas_ncc.py:67-87) in plain PyTorch, checks what it is
given, allocates the output, launches on the current stream and raises if
the launch failed. There is no fallback: a tensor the kernel does not
take raises.

``prepare`` does the per-solve part once (the sources' 2x2 elements,
homography constants and tap offsets, shared by every grid layout of the
solve; the reference-side weights of one layout), so a solve's 13
launches repeat none of it. The 2x2 elements are plain tensor code: for
8-bit sources (``PatchMatchParams.ncc_src_u8``, the default) one 32-bit
word of four bytes per pixel (``pack_2x2``), for float sources one quad
of four f32 (``pack_2x2_f32``); the kernel reads one element per tap
where it would read four pixels.

One launch serves a batch of B reference views: ref_img [B, H, W],
src_imgs [B, V, Hs, Ws], the ViewGeometry of the B views and
candidate-major planes [K, B, Hg, W, 4] give [K, B, Hg, W, V], with the
views' true source counts as B host ints; ``prepare`` then
builds every view's part with a leading [B]. The launch counts count
launches, not views. A single view's call is the batch of one, through
zero-copy views of its tensors."""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.kernels import (check_arg, hypothesis_stack,
                                     view_counts)
from acmmp_tpu_torch.ops import ncc as ncc_ops
from acmmp_tpu_torch.ops import parity

SUPPORTED_K = (1, 2, 3, 8)
_HEADER = 16        # consts floats before the per-view block (K^{-T})
_VIEW_STRIDE = 16   # consts floats per view: A (9), B (3), width, height

# launches of the kernel by K, on 8-bit sources (`launches`) and on float
# sources (`launches_f32`); the wrapper adds one where it launches and
# nowhere else
launches = {k: 0 for k in SUPPORTED_K}
launches_f32 = {k: 0 for k in SUPPORTED_K}


def reset_launch_counts() -> None:
    for counts in (launches, launches_f32):
        for k in counts:
            counts[k] = 0


def total_launches() -> int:
    return sum(launches.values()) + sum(launches_f32.values())


def source_type(params: PatchMatchParams) -> str:
    """"u8" for 8-bit sources (ncc_src_u8), else "f32"."""
    return "u8" if params.ncc_src_u8 else "f32"


class ZnccPrep(NamedTuple):
    """Per-solve inputs of the kernel for one grid layout. It holds one
    source type (`src_type`): the 8-bit sources and their words, or the
    float quads, never both. A batch's per-view fields lead with [B]."""

    src_u8: Optional[torch.Tensor]   # [(B,) V, Hs, Ws] uint8 (8-bit)
    src_q: Optional[torch.Tensor]    # [(B,) V, Hs, Ws] int32 2x2 words
    src_f4: Optional[torch.Tensor]   # [(B,) V, Hs, Ws, 4] f32 quads
    consts: torch.Tensor     # [(B,) 16 + 16 V] f32: K^{-T}, then A, B, w, h
    taps: torch.Tensor       # [T, 2] f32 (di, dj), shared by a batch
    w_taps: torch.Tensor     # [(B,) T, Hg, W] bilateral weights
    wr_taps: torch.Tensor    # [(B,) T, Hg, W] weights x centred ref taps
    refsums: torch.Tensor    # [(B,) 3, Hg, W] sum_w, sum_ref, sum_ref^2
    row_pack_off: int        # -1: full grid, else the parity offset off0

    @property
    def src_type(self) -> str:
        return "u8" if self.src_q is not None else "f32"

    def batch_of_one(self) -> "ZnccPrep":
        """A single view's prep as a batch of one (zero-copy views)."""
        lift = lambda t: None if t is None else t[None]      # noqa: E731
        return ZnccPrep(lift(self.src_u8), lift(self.src_q),
                        lift(self.src_f4), lift(self.consts), self.taps,
                        lift(self.w_taps), lift(self.wr_taps),
                        lift(self.refsums), self.row_pack_off)


def ref_side(ref_img: torch.Tensor, params: PatchMatchParams):
    """Per-tap reference weights and the reference-side ZNCC sums
    (``_ref_side``, pallas_ncc.py:67-87), on the full grid, over reference
    values centred on each pixel's own value (ops/ncc.py _zncc_grids).
    Returns (w [T, H, W], w * (ref_tap - ref) [T, H, W],
    [sum_w, sum_ref, sum_ref^2] [3, H, W]); for a batch, ref_img
    [B, H, W] gives each with a leading [B]."""
    inv_2sc2 = 1.0 / (2.0 * params.sigma_color ** 2)
    w_list, wr_list = [], []
    sum_w = sum_ref = sum_ref_ref = 0.0
    for di, dj, w_spatial in ncc_ops.tap_weights_spatial(params):
        ref_c = ncc_ops.shift_edge_hw(ref_img, dj, di) - ref_img
        w = w_spatial * torch.exp(-torch.abs(ref_c) * inv_2sc2)
        w_list.append(w)
        wr_list.append(w * ref_c)
        sum_w = sum_w + w
        sum_ref = sum_ref + w * ref_c
        sum_ref_ref = sum_ref_ref + w * ref_c * ref_c
    return (torch.stack(w_list, dim=-3), torch.stack(wr_list, dim=-3),
            torch.stack([sum_w, sum_ref, sum_ref_ref], dim=-3))


def _far_sides(src: torch.Tensor, widths: torch.Tensor,
               heights: torch.Tensor):
    """(x1, y1), each [V, Hs, Ws] int64, of every pixel of `src` [V, Hs,
    Ws]: x1 = min(x + 1, xi_max), y1 = min(y + 1, yi_max), where xi_max =
    (int)(width_v - 1) and yi_max = (int)(height_v - 1) in f32 as the
    kernel forms them: the clamp of its bilinear read to the view's true
    extent, which may be smaller than the padded Hs x Ws. Past the true
    extent the far side is kept inside the array."""
    V, Hs, Ws = src.shape

    def far(n, extent):
        # [V, n]: min(i + 1, (int)(extent - 1)), kept in [0, n)
        hi = (extent.to(torch.float32) - 1.0).to(torch.int64)
        i = torch.arange(n, device=src.device, dtype=torch.int64)
        return torch.clamp(torch.minimum(i + 1, hi[:, None]), 0, n - 1)

    return (far(Ws, widths)[:, None, :].expand(V, Hs, Ws),
            far(Hs, heights)[:, :, None].expand(V, Hs, Ws))


def pack_2x2(src_u8: torch.Tensor, widths: torch.Tensor,
             heights: torch.Tensor) -> torch.Tensor:
    """The 2x2 words the kernel gathers from 8-bit sources: [(B,) V, Hs,
    Ws] uint8 -> int32 with q[v, y, x] = b(y, x) | b(y, x1) << 8 | b(y1, x)
    << 16 | b(y1, x1) << 24, x1 and y1 the far sides of `_far_sides`
    (widths and heights [(B,) V]). A word past the true extent is never
    read."""
    shape = src_u8.shape
    src_u8 = src_u8.reshape((-1,) + shape[-2:])
    b = src_u8.to(torch.int64)
    x1, y1 = _far_sides(src_u8, widths.reshape(-1), heights.reshape(-1))
    down = torch.gather(b, 1, y1)
    q = (b | torch.gather(b, 2, x1) << 8 | down << 16
         | torch.gather(down, 2, x1) << 24)
    # the unsigned word's bits as int32
    return (q - ((q >> 31) << 32)).to(torch.int32).reshape(shape)


def pack_2x2_f32(src: torch.Tensor, widths: torch.Tensor,
                 heights: torch.Tensor) -> torch.Tensor:
    """The 2x2 quads the kernel gathers from float sources: [(B,) V, Hs,
    Ws] f32 -> [(B,) V, Hs, Ws, 4] f32 with q[v, y, x] = (s(y, x),
    s(y, x1), s(y1, x), s(y1, x1)), x1 and y1 the far sides of
    `_far_sides`, the order of pack_2x2's bytes. A quad past the true
    extent is never read."""
    shape = src.shape
    src = src.to(torch.float32).reshape((-1,) + shape[-2:])
    x1, y1 = _far_sides(src, widths.reshape(-1), heights.reshape(-1))
    down = torch.gather(src, 1, y1)
    return torch.stack([src, torch.gather(src, 2, x1), down,
                        torch.gather(down, 2, x1)], dim=-1).reshape(
                            shape + (4,)).contiguous()


def prepare(ref_img: torch.Tensor, src_imgs: torch.Tensor,
            vg: ncc_ops.ViewGeometry, params: PatchMatchParams,
            row_pack_off: Optional[int] = None,
            shared: Optional[ZnccPrep] = None) -> ZnccPrep:
    """The kernel's per-solve inputs for one layout (full grid when
    `row_pack_off` is None, else the parity-packed half grid), for the
    source type of `params` (source_type): the 8-bit sources and their
    2x2 words, or the float sources' 2x2 quads. `shared`, a prep of the
    same solve for another layout, gives the sources' elements, the
    constants and the taps, which do not depend on it. A batch's inputs
    (ref_img [B, H, W], src_imgs [B, V, Hs, Ws], its ViewGeometry) give
    the batch's prep, each per-view field with a leading [B]."""
    dev = ref_img.device
    kind = source_type(params)
    if shared is not None:
        if shared.src_type != kind:
            raise ValueError(f"zncc kernel: shared prep holds "
                             f"{shared.src_type} sources, params ask for "
                             f"{kind}")
        src_u8, src_q, src_f4 = shared.src_u8, shared.src_q, shared.src_f4
        consts, taps = shared.consts, shared.taps
    else:
        src_u8 = src_q = src_f4 = None
        if kind == "u8":
            src_u8 = torch.round(torch.clamp(src_imgs, 0.0, 255.0)).to(
                torch.uint8).contiguous()
            src_q = pack_2x2(src_u8, vg.src_width, vg.src_height)
        else:
            src_f4 = pack_2x2_f32(src_imgs, vg.src_width, vg.src_height)
        lead, V = src_imgs.shape[:-3], src_imgs.shape[-3]
        consts = torch.zeros(lead + (_HEADER + _VIEW_STRIDE * V,),
                             dtype=torch.float32, device=dev)
        consts[..., :9] = vg.KrT.reshape(lead + (9,))
        per_view = consts[..., _HEADER:].view(lead + (V, _VIEW_STRIDE))
        per_view[..., :9] = vg.A.reshape(lead + (V, 9))
        per_view[..., 9:12] = vg.B
        per_view[..., 12] = vg.src_width
        per_view[..., 13] = vg.src_height
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
    return ZnccPrep(src_u8, src_q, src_f4, consts, taps, w_taps.contiguous(),
                    wr_taps.contiguous(), refsums.contiguous(), off)


def _lib():
    from acmmp_tpu_torch.kernels import _build

    lib = _build.load("zncc")
    fn = lib.acmmp_zncc_launch
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([ci, ci] + [vp] * 7 + [ctypes.POINTER(ci), vp]
                       + [ci] * 7 + [cf, cf, ci, cf, cf, vp])
        fn.restype = ci
        occ = lib.acmmp_zncc_occupancy
        occ.argtypes = [ci, ci, ci, ci, ctypes.POINTER(ci),
                        ctypes.POINTER(ci)]
        occ.restype = ci
    return lib


def occupancy(K: int, T: int, src_type: str = "u8", batched: bool = False):
    """(blocks of the K kernel on `src_type` sources ("u8" or "f32") an
    SM holds with T taps, by the CUDA runtime's occupancy calculator;
    threads per block), of its instantiation for a batch (`batched`) or
    for one view."""
    blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
    rc = _lib().acmmp_zncc_occupancy(
        int(K), int(src_type == "f32"), int(T), int(batched),
        ctypes.byref(blocks), ctypes.byref(threads))
    if rc != 0:
        raise RuntimeError(f"zncc kernel occupancy failed: cudaError {rc}")
    return blocks.value, threads.value


def multiview_zncc_cuda(ref_img, src_imgs, vg: ncc_ops.ViewGeometry, planes,
                        params: PatchMatchParams, origin=None,
                        row_pack_off=None, n_views=None,
                        prep: Optional[ZnccPrep] = None) -> torch.Tensor:
    """Per-view ZNCC costs through the kernel: planes [K, Hg, W, 4] (or
    [Hg, W, 4]) -> [K, Hg, W, V] (or [Hg, W, V]); Hg = H, or H // 2 with
    parity packing (`row_pack_off` = off0). For a batch (ref_img
    [B, H, W], src_imgs [B, V, Hs, Ws], vg of the B views), planes
    [K, B, Hg, W, 4] (or [B, Hg, W, 4]) -> [K, B, Hg, W, V] (or
    [B, Hg, W, V]). `n_views`: a host int, or for a batch a sequence of B
    host ints (kernels.view_counts)."""
    batched = ref_img.ndim == 3
    if not batched:
        if prep is None:
            prep = prepare(ref_img, src_imgs, vg, params, row_pack_off)
        prep = prep.batch_of_one()
        ref_img, src_imgs = ref_img[None], src_imgs[None]
        planes = planes.unsqueeze(-4)
    planes, squeeze = hypothesis_stack("zncc", planes, SUPPORTED_K,
                                       batched=True)
    K = planes.shape[0]
    B, H, W = ref_img.shape
    V, Hs, Ws = src_imgs.shape[-3:]
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
    if prep.src_type != source_type(params):
        raise ValueError(f"zncc kernel: prep holds {prep.src_type} "
                         f"sources, params ask for {source_type(params)}")
    f32 = prep.src_type == "f32"
    T = prep.taps.shape[0]
    check_arg("zncc", "planes", planes, torch.float32, (K, B, Hg, W, 4), dev)
    if f32:
        src = prep.src_f4
        check_arg("zncc", "src_f4", src, torch.float32, (B, V, Hs, Ws, 4),
                  dev)
        if src.data_ptr() % 16:
            raise ValueError("zncc kernel: src_f4 must be 16-byte aligned")
    else:
        src = prep.src_q
        check_arg("zncc", "src_q", src, torch.int32, (B, V, Hs, Ws), dev)
    check_arg("zncc", "consts", prep.consts, torch.float32,
              (B, _HEADER + _VIEW_STRIDE * V), dev)
    check_arg("zncc", "taps", prep.taps, torch.float32, (T, 2), dev)
    check_arg("zncc", "w_taps", prep.w_taps, torch.float32, (B, T, Hg, W),
              dev)
    check_arg("zncc", "wr_taps", prep.wr_taps, torch.float32, (B, T, Hg, W),
              dev)
    check_arg("zncc", "refsums", prep.refsums, torch.float32, (B, 3, Hg, W),
              dev)
    if planes.data_ptr() % 16:
        raise ValueError("zncc kernel: planes must be 16-byte aligned")
    # every index is formed in size_t from per-view blocks whose own
    # offsets fit 32 bits; the guard counts the whole batch all the same
    if K * B * Hg * W * V >= 2 ** 31 or B * V * Hs * Ws >= 2 ** 31:
        raise ValueError("zncc kernel: problem too large for 32-bit indexing")
    if max(Hs, Ws) >= 2 ** 23:
        # the kernel's floor (s + 2^23 rounded down) is exact below 2^23
        raise ValueError("zncc kernel: sources wider or taller than 2^23")
    nv = view_counts("zncc", n_views, B, V)
    oy, ox = (0.0, 0.0) if origin is None else (float(origin[0]),
                                                float(origin[1]))

    out = torch.empty((K, B, Hg, W, V), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().acmmp_zncc_launch(
            K, int(f32), planes.data_ptr(), src.data_ptr(),
            prep.w_taps.data_ptr(), prep.wr_taps.data_ptr(),
            prep.refsums.data_ptr(), prep.consts.data_ptr(),
            prep.taps.data_ptr(), nv, out.data_ptr(), B, V, Hg, W,
            Hs, Ws, T, oy, ox, prep.row_pack_off, float(params.cost_max),
            float(params.min_var), stream)
    if rc != 0:
        raise RuntimeError(f"zncc kernel launch failed: cudaError {rc}")
    (launches_f32 if f32 else launches)[K] += 1
    if not batched:
        out = out[:, 0]
    return out[0] if squeeze else out
