"""Wrapper of the fusion sampler's CUDA kernel (csrc/sample.cu).

The kernel stands in for the JAX package's Pallas kernel
``gather2d_pallas`` (pallas_sample.py:32) and is held bitwise against the
plain version in ops/sample.py. The wrapper checks what it is given,
allocates the output, launches on the current stream and raises if the
launch failed. There is no fallback: a tensor the kernel does not take
raises."""

from __future__ import annotations

import ctypes

import torch

from acmmp_tpu_torch.kernels import check_arg

# launches of the kernel, in all and by the maps' channel count C; the
# wrapper adds one to each where it launches and nowhere else
launches = {"gather2d": 0}
launches_by_channels = {}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0
    launches_by_channels.clear()


def total_launches() -> int:
    return sum(launches.values())


def _lib():
    from acmmp_tpu_torch.kernels import _build

    lib = _build.load("sample")
    fn = lib.acmmp_gather2d_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 5 + [ci] * 6 + [vp]
        fn.restype = ci
    return fn


def gather2d_cuda(maps: torch.Tensor, rr: torch.Tensor, cc: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """`maps` [V, C, Hs, Ws] f32 read at (`rr`, `cc`) [V, H, W] int32
    where `valid` [V, H, W] bool, zeros elsewhere -> [V, C, H, W] f32.
    Valid lanes must carry in-range indices; invalid lanes are not read."""
    if not maps.is_cuda:
        raise RuntimeError("gather2d kernel: maps must be a CUDA tensor "
                           "(CPU tensors take sample_backend='auto' or "
                           "'plain')")
    if maps.ndim != 4 or rr.ndim != 3:
        raise ValueError(f"gather2d kernel: maps must be [V, C, Hs, Ws] and "
                         f"rr [V, H, W], got {tuple(maps.shape)} and "
                         f"{tuple(rr.shape)}")
    V, C, Hs, Ws = maps.shape
    H, W = rr.shape[1:]
    dev = maps.device
    check_arg("gather2d", "maps", maps, torch.float32, (V, C, Hs, Ws), dev)
    check_arg("gather2d", "rr", rr, torch.int32, (V, H, W), dev)
    check_arg("gather2d", "cc", cc, torch.int32, (V, H, W), dev)
    check_arg("gather2d", "valid", valid, torch.bool, (V, H, W), dev)
    if V * C * max(Hs * Ws, H * W) >= 2 ** 31 or V >= 65536:
        raise ValueError("gather2d kernel: problem too large for 32-bit "
                         "indexing")
    out = torch.empty((V, C, H, W), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib()(maps.data_ptr(), rr.data_ptr(), cc.data_ptr(),
                    valid.data_ptr(), out.data_ptr(), V, C, Hs, Ws, H, W,
                    stream)
    if rc != 0:
        raise RuntimeError(f"gather2d kernel launch failed: cudaError {rc}")
    launches["gather2d"] += 1
    launches_by_channels[C] = launches_by_channels.get(C, 0) + 1
    return out
