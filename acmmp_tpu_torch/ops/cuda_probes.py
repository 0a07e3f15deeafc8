"""Wrapper of the lane-probe kernels (csrc/probes.cu).

The kernels stand in for the TPU kernels of the JAX package's
``tools/mosaic_probe.py`` and ``tools/prop_ablate.py::nan_take_probe``;
ops/probes.py holds their plain versions. The wrapper checks what it is
given ([8, 128] int32 words, int32 indices or shifts, bool selects, all
on one CUDA device), allocates the output, launches on the current stream
and raises if the launch failed. There is no fallback."""

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

# launches by probe; the wrapper adds one where it launches and nowhere
# else
launches = {name: 0 for name in PROBES}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def total_launches() -> int:
    return sum(launches.values())


def _lib():
    from acmmp_tpu_torch.kernels import _build

    lib = _build.load("probes")
    fn = lib.acmmp_probe_launch
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int] + [vp] * 5
        fn.restype = ctypes.c_int
    return fn


def probe_cuda(name: str, w: torch.Tensor, *args) -> torch.Tensor:
    """Probe `name` through its kernel: w [8, 128] int32 plus its indices
    or shifts (int32) and selects (bool) -> [8, 128] int32, or float32
    for dyn_lane_shift and unpack4_static."""
    if name not in _PROBE_ID:
        raise ValueError(f"probe kernel: probe must be one of {PROBES}, "
                         f"got {name!r}")
    if not w.is_cuda:
        raise RuntimeError(f"probe kernel {name}: w must be a CUDA tensor")
    wants = ARGS[name]
    if len(args) != len(wants):
        raise TypeError(f"probe kernel {name}: takes w and {wants}, got "
                        f"{len(args)} more arguments")
    dev = w.device
    shape = (ROWS, LANES)
    check_arg(f"probe {name}", "w", w, torch.int32, shape, dev)
    ptrs = {"idx": None, "shift": None, "sel": None}
    for arg, t in zip(wants, args):
        dtype = torch.bool if arg == "sel" else torch.int32
        check_arg(f"probe {name}", arg, t, dtype, shape, dev)
        ptrs[arg] = t.data_ptr()
    aux = ptrs["idx"] if ptrs["idx"] is not None else ptrs["shift"]
    out = torch.empty(shape, device=dev, dtype=torch.float32
                      if name in _FLOAT_OUT else torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib()(_PROBE_ID[name], w.data_ptr(), aux, ptrs["sel"],
                    out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"probe kernel {name} launch failed: "
                           f"cudaError {rc}")
    launches[name] += 1
    return out
