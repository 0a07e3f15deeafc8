"""Wrapper of the ZNCC ablation kernel (csrc/ablate.cu).

The kernel stands in for the TPU kernel of the JAX package's
``tools/prop_ablate.py::ablate_call``: the first design of zncc.cu's
K = 8 stack (kept frozen as the redesign's yardstick) with parts
of its work switched off by mode (ops/ablate.py says what each mode keeps
and holds their plain versions). The wrapper reuses ``cuda_ncc.prepare``
for the u8 sources, the homography constants, the taps and the
reference-side sums, checks what it is given, allocates the output,
launches on the current stream and raises if the launch failed. There is
no fallback: a tensor the kernel does not take raises."""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.kernels import check_arg, hypothesis_stack
from acmmp_tpu_torch.ops import cuda_ncc
from acmmp_tpu_torch.ops import ncc as ncc_ops
from acmmp_tpu_torch.ops.ablate import MODES

K = 8
# the C entry's mode numbers: 0-3 on u8 sources, 4 full on f32 sources
_MODE_ID = {"full": 0, "noext": 1, "nobounds": 2, "noscan": 3, "f32take": 4}

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

    zncc: cuda_ncc.ZnccPrep    # sources, constants, taps, ref side
    src_f32: torch.Tensor      # [V, Hs, Ws] f32 sources f32take reads


def prepare(ref_img: torch.Tensor, src_imgs: torch.Tensor,
            vg: ncc_ops.ViewGeometry, params: PatchMatchParams,
            off0: int) -> AblatePrep:
    """The inputs of every mode on the parity-packed grid `off0`; the
    f32take sources are the 8-bit ones widened here, once, outside any
    timed launch. f32take alone also runs on an AblatePrep of a float-
    source prep (cuda_ncc.prepare with ncc_src_u8=False) and any f32
    sources, the first design on those."""
    zp = cuda_ncc.prepare(ref_img, src_imgs, vg, params, off0)
    return AblatePrep(zp, zp.src_u8.to(torch.float32))


def _lib():
    from acmmp_tpu_torch.kernels import _build

    lib = _build.load("ablate")
    fn = lib.acmmp_ablate_launch
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([ci] + [vp] * 8 + [ci] * 7
                       + [cf, cf, ci, cf, cf, cf, ci, ci, vp])
        fn.restype = ci
        occ = lib.acmmp_ablate_occupancy
        occ.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
        occ.restype = ci
    return lib


def occupancy(mode: str, smem_bytes: int = 0, carveout: int = -1) -> int:
    """Blocks of `mode` an SM holds at a launch's dynamic shared memory and
    carveout preference (percent, -1 the driver's default), by the CUDA
    runtime's occupancy calculator."""
    blocks = ctypes.c_int(0)
    rc = _lib().acmmp_ablate_occupancy(_MODE_ID[mode], int(smem_bytes),
                                       int(carveout), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"ablate kernel occupancy failed: cudaError {rc}")
    return blocks.value


def ablate_cuda(mode: str, planes: torch.Tensor, prep: AblatePrep,
                params: PatchMatchParams, n_views: Optional[int] = None,
                smem_bytes: int = 0, carveout: int = -1) -> torch.Tensor:
    """Costs of `mode` through the kernel: packed planes [8, Hg, W, 4] ->
    [8, Hg, W, V]. `n_views` (host int) is the true view count; padded
    view slots get cost_max. `smem_bytes` of dynamic shared memory (the
    kernel uses none) and a `carveout` preference in percent limit the
    blocks per SM, to time modes of different register counts at one
    occupancy; the defaults launch as the first design did."""
    if mode not in MODES:
        raise ValueError(f"ablate kernel: mode must be one of {MODES}, "
                         f"got {mode!r}")
    planes, _ = hypothesis_stack("ablate", planes, (K,))
    zp = prep.zncc
    if zp.row_pack_off < 0:
        raise ValueError("ablate kernel: prep must be for a packed grid")
    dev = planes.device
    T, Hg, W = zp.w_taps.shape
    V, Hs, Ws = prep.src_f32.shape
    check_arg("ablate", "planes", planes, torch.float32, (K, Hg, W, 4), dev)
    if mode == "f32take":
        src = prep.src_f32
        check_arg("ablate", "src_f32", src, torch.float32, (V, Hs, Ws), dev)
    else:
        src = zp.src_u8
        if src is None:
            raise ValueError(f"ablate kernel: mode {mode!r} reads 8-bit "
                             "sources, the prep holds float ones")
        check_arg("ablate", "src_u8", src, torch.uint8, (V, Hs, Ws), dev)
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
    nv = V if n_views is None else int(n_views)

    out = torch.empty((K, Hg, W, V), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().acmmp_ablate_launch(
            _MODE_ID[mode], planes.data_ptr(), src.data_ptr(),
            zp.w_taps.data_ptr(), zp.wr_taps.data_ptr(),
            zp.refsums.data_ptr(), zp.consts.data_ptr(), zp.taps.data_ptr(),
            out.data_ptr(), V, nv, Hg, W, Hs, Ws, T, 0.0, 0.0,
            zp.row_pack_off, float(params.cost_max), float(params.min_var),
            0.0, int(smem_bytes), int(carveout), stream)
    if rc != 0:
        raise RuntimeError(f"ablate kernel launch failed: cudaError {rc}")
    launches[mode] += 1
    return out
