"""Wrapper of the geometric-consistency CUDA kernel (csrc/geom.cu).

The kernel stands in for the JAX package's Pallas kernel
``geom_consistency_cost_pallas`` (pallas_geom.py:49) and is held against
the plain version in ops/geom.py. The wrapper checks what it is given,
allocates the output, launches on the current stream and raises if the
launch failed. There is no fallback: a tensor the kernel does not take
raises.

``prepare`` does the per-solve part once (the camera constants and the
contiguous depth stack), so a geometric solve's 9 launches repeat none
of it.

``geom_first_cuda`` launches the kernel's first design, kept frozen in
the same source as the yardstick of the redesign (bitwise and in time);
only chip_smoke.py and the cuda-marked test call it, and its launches
count in ``first_launches``, apart from ``launches``."""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.core import geometry as geo
from acmmp_tpu_torch.kernels import check_arg, hypothesis_stack

SUPPORTED_K = (1, 5, 8)
_HEADER = 24        # consts floats of the reference camera: K, R, t
_VIEW_STRIDE = 24   # consts floats per view: K, R, t, width, height

# launches of the kernel by K, and of its first design; each wrapper adds
# one where it launches and nowhere else
launches = {k: 0 for k in SUPPORTED_K}
first_launches = {k: 0 for k in SUPPORTED_K}


def reset_launch_counts() -> None:
    for counts in (launches, first_launches):
        for k in counts:
            counts[k] = 0


def total_launches() -> int:
    return sum(launches.values())


class GeomPrep(NamedTuple):
    """Per-solve inputs of the kernel."""

    consts: torch.Tensor   # [24 + 24 V] f32
    depths: torch.Tensor   # [V, Hs, Ws] f32, contiguous


def _cam_block(cam: geo.Camera, n: int) -> torch.Tensor:
    """[..., n] floats: K (9), R (9), t (3), then width, height, zeros."""
    lead = cam.t.shape[:-1]
    parts = [cam.K.reshape(lead + (9,)), cam.R.reshape(lead + (9,)), cam.t,
             cam.width[..., None], cam.height[..., None]]
    block = torch.cat(parts, dim=-1).to(torch.float32)
    return torch.nn.functional.pad(block, (0, n - block.shape[-1]))


def prepare(ref_cam: geo.Camera, src_cams: geo.Camera,
            src_depths: torch.Tensor) -> GeomPrep:
    """The kernel's per-solve inputs."""
    consts = torch.cat([_cam_block(ref_cam, _HEADER),
                        _cam_block(src_cams, _VIEW_STRIDE).reshape(-1)])
    return GeomPrep(consts.contiguous(), src_depths.contiguous())


def _lib():
    from acmmp_tpu_torch.kernels import _build

    lib = _build.load("geom")
    if lib.acmmp_geom_launch.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for fn in (lib.acmmp_geom_launch, lib.acmmp_geom_first_launch):
            fn.argtypes = [ci] + [vp] * 4 + [ci] * 7 + [cf, vp]
            fn.restype = ci
        occ = lib.acmmp_geom_occupancy
        occ.argtypes = [ci, ctypes.POINTER(ci), ctypes.POINTER(ci)]
        occ.restype = ci
    return lib


def occupancy(V: int):
    """(blocks of the kernel an SM holds for V views, by the CUDA
    runtime's occupancy calculator; threads per block)."""
    blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
    rc = _lib().acmmp_geom_occupancy(int(V), ctypes.byref(blocks),
                                     ctypes.byref(threads))
    if rc != 0:
        raise RuntimeError(f"geom kernel occupancy failed: cudaError {rc}")
    return blocks.value, threads.value


def geom_consistency_cost_cuda(ref_cam: geo.Camera, src_cams: geo.Camera,
                               src_depths: torch.Tensor,
                               planes: torch.Tensor, params: PatchMatchParams,
                               row_pack_off=None, n_views=None,
                               prep: Optional[GeomPrep] = None
                               ) -> torch.Tensor:
    """Reprojection errors through the kernel: planes [K, Hg, W, 4] (or
    [Hg, W, 4]) -> [K, Hg, W, V] (or [Hg, W, V]). The kernel rebuilds the
    pixel grid from the parity offset `row_pack_off` (host int, None for
    the full grid). `n_views` is a host int."""
    return _launch("acmmp_geom_launch", launches, ref_cam, src_cams,
                   src_depths, planes, params, row_pack_off, n_views, prep)


def geom_first_cuda(ref_cam: geo.Camera, src_cams: geo.Camera,
                    src_depths: torch.Tensor, planes: torch.Tensor,
                    params: PatchMatchParams, row_pack_off=None,
                    n_views=None, prep: Optional[GeomPrep] = None
                    ) -> torch.Tensor:
    """geom_consistency_cost_cuda through the kernel's first design, the
    redesign's yardstick; its launches count in `first_launches`."""
    return _launch("acmmp_geom_first_launch", first_launches, ref_cam,
                   src_cams, src_depths, planes, params, row_pack_off,
                   n_views, prep)


def _launch(entry, counts, ref_cam, src_cams, src_depths, planes, params,
            row_pack_off, n_views, prep):
    planes, squeeze = hypothesis_stack("geom", planes, SUPPORTED_K)
    K, Hg, W = planes.shape[:3]
    V, Hs, Ws = src_depths.shape
    dev = planes.device
    if prep is None:
        prep = prepare(ref_cam, src_cams, src_depths)
    check_arg("geom", "planes", planes, torch.float32, (K, Hg, W, 4), dev)
    check_arg("geom", "depths", prep.depths, torch.float32, (V, Hs, Ws), dev)
    check_arg("geom", "consts", prep.consts, torch.float32,
              (_HEADER + _VIEW_STRIDE * V,), dev)
    if planes.data_ptr() % 16:
        raise ValueError("geom kernel: planes must be 16-byte aligned")
    if K * Hg * W * V >= 2 ** 31 or V * Hs * Ws >= 2 ** 31:
        raise ValueError("geom kernel: problem too large for 32-bit indexing")
    nv = V if n_views is None else int(n_views)
    off = -1 if row_pack_off is None else int(row_pack_off)

    out = torch.empty((K, Hg, W, V), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = getattr(_lib(), entry)(
            K, planes.data_ptr(), prep.depths.data_ptr(),
            prep.consts.data_ptr(), out.data_ptr(), V, nv, Hg, W, Hs, Ws, off,
            float(params.geom_cost_max), stream)
    if rc != 0:
        raise RuntimeError(f"geom kernel launch failed: cudaError {rc}")
    counts[K] += 1
    return out[0] if squeeze else out
