"""Wrapper of the ZNCC ablation kernel (csrc/ablate.cu).

The kernel stands in for the TPU kernel of the JAX package's
``tools/prop_ablate.py::ablate_call``: zncc.cu's K = 8 stack with parts
of its tap loop switched off by mode, beside zncc.cu's first design
(``first``, frozen as its yardstick); ops/ablate.py says what each mode
keeps and holds their plain versions. The wrapper reuses
``cuda_ncc.prepare`` for the 8-bit sources and their 2x2 words, the
homography constants, the taps and the reference-side sums, checks what
it is given, allocates the output, launches on the current stream and
raises if the launch failed. There is no fallback: a tensor the kernel
does not take raises."""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional

import torch

from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.kernels import check_arg, hypothesis_stack
from acmmp_tpu_torch.ops import cuda_ncc
from acmmp_tpu_torch.ops import ncc as ncc_ops
from acmmp_tpu_torch.ops.ablate import MODES

K = 8
# the C entry's mode numbers
_MODE_ID = {m: i for i, m in enumerate(MODES)}

# launches of the kernel by mode; the wrapper adds one where it launches
# and nowhere else
launches = {m: 0 for m in MODES}


def reset_launch_counts() -> None:
    for m in launches:
        launches[m] = 0


def total_launches() -> int:
    return sum(launches.values())


class AblatePrep(NamedTuple):
    """The kernel's inputs for one packed layout."""

    zncc: cuda_ncc.ZnccPrep    # 2x2 words, constants, taps, ref side
    src_first: torch.Tensor    # [V, Hs, Ws] the first design's sources:
    #                            uint8, or f32 (its float instantiation)
    src_f4: Optional[torch.Tensor]   # [V, Hs, Ws, 4] f32take's 2x2 quads


def prepare(ref_img: torch.Tensor, src_imgs: torch.Tensor,
            vg: ncc_ops.ViewGeometry, params: PatchMatchParams,
            off0: int) -> AblatePrep:
    """The inputs of every mode on the parity-packed grid `off0`, from the
    8-bit sources: their bytes (first), their 2x2 words (full, noext,
    nobounds, noscan) and the 2x2 f32 quads of the bytes widened (f32take),
    built here, once, outside any timed launch."""
    zp = cuda_ncc.prepare(ref_img, src_imgs, vg,
                          dataclasses.replace(params, ncc_src_u8=True), off0)
    quads = cuda_ncc.pack_2x2_f32(zp.src_u8.to(torch.float32),
                                  vg.src_width, vg.src_height)
    return AblatePrep(zp, zp.src_u8, quads)


def _lib():
    from acmmp_tpu_torch.kernels import _build

    lib = _build.load("ablate")
    fn = lib.acmmp_ablate_launch
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([ci, ci] + [vp] * 8 + [ci] * 7
                       + [cf, cf, ci, cf, cf, ci, vp])
        fn.restype = ci
        occ = lib.acmmp_ablate_occupancy
        occ.argtypes = [ci] * 3 + [ctypes.POINTER(ci)] * 2
        occ.restype = ci
    return lib


def occupancy(mode: str, T: int, smem_bytes: int = 0):
    """(blocks of `mode` an SM holds with T taps at a launch's dynamic
    shared memory, by the CUDA runtime's occupancy calculator; threads per
    block)."""
    blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
    rc = _lib().acmmp_ablate_occupancy(
        _MODE_ID[mode], int(T), int(smem_bytes), ctypes.byref(blocks),
        ctypes.byref(threads))
    if rc != 0:
        raise RuntimeError(f"ablate kernel occupancy failed: cudaError {rc}")
    return blocks.value, threads.value


def ablate_cuda(mode: str, planes: torch.Tensor, prep: AblatePrep,
                params: PatchMatchParams, n_views: Optional[int] = None,
                smem_bytes: int = 0) -> torch.Tensor:
    """Costs of `mode` through the kernel: packed planes [8, Hg, W, 4] ->
    [8, Hg, W, V]. `n_views` (host int) is the true view count; padded
    view slots get cost_max. `first` reads prep.src_first, uint8 or f32
    (the first design's float instantiation). `smem_bytes` of dynamic
    shared memory (the mode's own if that is more) limits the blocks per
    SM, to time modes of different register counts at one occupancy; the
    default launches as zncc.cu does."""
    if mode not in MODES:
        raise ValueError(f"ablate kernel: mode must be one of {MODES}, "
                         f"got {mode!r}")
    planes, _ = hypothesis_stack("ablate", planes, (K,))
    zp = prep.zncc
    if zp.row_pack_off < 0:
        raise ValueError("ablate kernel: prep must be for a packed grid")
    dev = planes.device
    T, Hg, W = zp.w_taps.shape
    V, Hs, Ws = prep.src_first.shape
    check_arg("ablate", "planes", planes, torch.float32, (K, Hg, W, 4), dev)
    first_f32 = False
    if mode == "first":
        src = prep.src_first
        first_f32 = src.dtype == torch.float32
        check_arg("ablate", "src_first", src,
                  torch.float32 if first_f32 else torch.uint8, (V, Hs, Ws),
                  dev)
    elif mode == "f32take":
        src = prep.src_f4
        if src is None:
            raise ValueError("ablate kernel: the prep holds no f32 quads")
        check_arg("ablate", "src_f4", src, torch.float32, (V, Hs, Ws, 4),
                  dev)
        if src.data_ptr() % 16:
            raise ValueError("ablate kernel: src_f4 must be 16-byte aligned")
    else:
        src = zp.src_q
        if src is None:
            raise ValueError(f"ablate kernel: mode {mode!r} reads 8-bit "
                             "sources' words, the prep holds float ones")
        check_arg("ablate", "src_q", src, torch.int32, (V, Hs, Ws), dev)
    check_arg("ablate", "consts", zp.consts, torch.float32,
              (cuda_ncc._HEADER + cuda_ncc._VIEW_STRIDE * V,), dev)
    check_arg("ablate", "taps", zp.taps, torch.float32, (T, 2), dev)
    check_arg("ablate", "w_taps", zp.w_taps, torch.float32, (T, Hg, W), dev)
    check_arg("ablate", "wr_taps", zp.wr_taps, torch.float32, (T, Hg, W),
              dev)
    check_arg("ablate", "refsums", zp.refsums, torch.float32, (3, Hg, W),
              dev)
    if planes.data_ptr() % 16:
        raise ValueError("ablate kernel: planes must be 16-byte aligned")
    if K * Hg * W * V >= 2 ** 31 or V * Hs * Ws >= 2 ** 31:
        raise ValueError("ablate kernel: problem too large for 32-bit "
                         "indexing")
    if max(Hs, Ws) >= 2 ** 23:
        # floor_u23 (s + 2^23 rounded down) is exact below 2^23
        raise ValueError("ablate kernel: sources wider or taller than 2^23")
    nv = V if n_views is None else int(n_views)

    out = torch.empty((K, Hg, W, V), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().acmmp_ablate_launch(
            _MODE_ID[mode], int(first_f32), planes.data_ptr(),
            src.data_ptr(), zp.w_taps.data_ptr(), zp.wr_taps.data_ptr(),
            zp.refsums.data_ptr(), zp.consts.data_ptr(), zp.taps.data_ptr(),
            out.data_ptr(), V, nv, Hg, W, Hs, Ws, T, 0.0, 0.0,
            zp.row_pack_off, float(params.cost_max), float(params.min_var),
            int(smem_bytes), stream)
    if rc != 0:
        raise RuntimeError(f"ablate kernel launch failed: cudaError {rc}")
    launches[mode] += 1
    return out
