"""Wrapper of the lane-probe kernels (csrc/probes.cu).

The kernels stand in for the TPU kernels of the JAX package's
``tools/mosaic_probe.py`` and ``tools/prop_ablate.py::nan_take_probe``;
ops/probes.py holds their plain versions. The wrapper checks what it is
given ([8, 128] int32 words, int32 indices or shifts, bool selects, all
on one CUDA device, contiguous), allocates the output, launches on the
current stream and raises if the launch failed. There is no fallback.

A probe's kernel takes about 2 us of the card; its call is the wrapper's
host time. So the call does the least it can: the bound C function is
resolved once; every argument is checked in one pass of attribute reads
(check_arg only builds the error); the device is entered only when it is
not the current one; the stream handle is read raw, once
(torch.cuda.current_stream() builds a Stream object at every call)."""

from __future__ import annotations

import ctypes

import torch

from acmmp_tpu_torch.kernels import check_arg
from acmmp_tpu_torch.ops.probes import LANES, PROBES, ROWS

# the C entry's probe numbers, and what each takes besides the words
_PROBE_ID = {name: i for i, name in enumerate(PROBES)}
ARGS = {"taa_i32_axis1": ("idx",), "taa_i32_axis0": ("idx",),
        "dyn_lane_shift": ("shift",), "unpack4_static": (),
        "take_select_i32": ("idx", "sel"), "take_select_f32": ("idx", "sel")}
_FLOAT_OUT = ("dyn_lane_shift", "unpack4_static")
_SHAPE = (ROWS, LANES)
# each probe's arguments as (name, dtype), the words first, and its
# output dtype
_SIGNATURE = {name: (("w", torch.int32),) + tuple(
    (a, torch.bool if a == "sel" else torch.int32) for a in ARGS[name])
    for name in PROBES}
_OUT_DTYPE = {name: torch.float32 if name in _FLOAT_OUT else torch.int32
              for name in PROBES}

# launches by probe; the wrapper adds one where it launches and nowhere
# else
launches = {name: 0 for name in PROBES}

_launch = None   # the bound C entry, once loaded


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def total_launches() -> int:
    return sum(launches.values())


def _fn():
    global _launch
    if _launch is None:
        from acmmp_tpu_torch.kernels import _build

        fn = _build.load("probes").acmmp_probe_launch
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _refuse(name: str, tensors, dev) -> None:
    """Raise for the first argument of `name` the kernel does not take."""
    for (arg, dtype), t in zip(_SIGNATURE[name], tensors):
        check_arg(f"probe {name}", arg, t, dtype, _SHAPE, dev)


def probe_cuda(name: str, w: torch.Tensor, *args) -> torch.Tensor:
    """Probe `name` through its kernel: w [8, 128] int32 plus its indices
    or shifts (int32) and selects (bool) -> [8, 128] int32, or float32
    for dyn_lane_shift and unpack4_static."""
    pid = _PROBE_ID.get(name)
    if pid is None:
        raise ValueError(f"probe kernel: probe must be one of {PROBES}, "
                         f"got {name!r}")
    if not w.is_cuda:
        raise RuntimeError(f"probe kernel {name}: w must be a CUDA tensor")
    sig = _SIGNATURE[name]
    if len(args) != len(sig) - 1:
        raise TypeError(f"probe kernel {name}: takes w and {ARGS[name]}, "
                        f"got {len(args)} more arguments")
    index = w.get_device()
    tensors = (w,) + args
    for (_, dtype), t in zip(sig, tensors):
        if (t.dtype != dtype or t.get_device() != index
                or t.shape != _SHAPE or not t.is_contiguous()):
            _refuse(name, tensors, w.device)
    aux = args[0].data_ptr() if args else None
    sel = args[1].data_ptr() if len(args) > 1 else None
    out = torch.empty_like(w, dtype=_OUT_DTYPE[name])
    launch = _launch or _fn()
    if index == torch.cuda.current_device():
        rc = launch(pid, w.data_ptr(), aux, sel, out.data_ptr(),
                    torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = launch(pid, w.data_ptr(), aux, sel, out.data_ptr(),
                        torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"probe kernel {name} launch failed: "
                           f"cudaError {rc}")
    launches[name] += 1
    return out
