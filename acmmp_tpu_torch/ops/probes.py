"""The lane probes of the JAX package's TPU tools, in plain PyTorch: what
csrc/probes.cu computes, and what it is held against.

``tools/mosaic_probe.py`` asked whether Mosaic lowers the operations the
packed-gather ZNCC kernel needed, on one (8, 128) tile of int32 words: a
lane gather along each axis (``k_taa_i32`` :36, ``k_taa_axis0_i32`` :53),
a per-lane variable shift (``k_dyn_shift`` :40) and a byte unpack
(``k_unpack`` :45). ``tools/prop_ablate.py::nan_take_probe`` (:436) asked
whether a gather and select through f32-bitcast words keeps every bit
pattern (signalling and quiet NaNs, infinities, -0), so that f32 gathers
could carry packed bytes. Every probe here takes [8, 128] int32 words and
returns [8, 128] int32 or float32 values; none does arithmetic on a float
that carries a word, so no NaN is quieted."""

from __future__ import annotations

import numpy as np
import torch

ROWS, LANES = 8, 128


def taa_i32_axis1(w, idx):
    """o[r, c] = w[r, idx[r, c]] (k_taa_i32)."""
    return torch.take_along_dim(w, idx.long(), 1)


def taa_i32_axis0(w, idx):
    """o[r, c] = w[idx[r, c] % 8, c] (k_taa_axis0_i32; % is floor mod)."""
    return torch.take_along_dim(w, torch.remainder(idx, ROWS).long(), 0)


def dyn_lane_shift(w, s):
    """float((uint32 w >> s) & 0xFF) with a shift s per lane; 0 for a
    shift outside [0, 32), as a logical shift by the word's width or more
    gives (k_dyn_shift)."""
    u = w.long() & 0xFFFFFFFF
    s = s.long()
    ok = (s >= 0) & (s < 32)
    byte = (u >> torch.where(ok, s, 0)) & 0xFF
    return torch.where(ok, byte, 0).to(torch.float32)


def unpack4_static(w):
    """The four bytes of each word, 0 (lowest) to 3, summed in that order
    as float32 (k_unpack)."""
    u = w.long() & 0xFFFFFFFF
    acc = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    for k in range(4):
        acc = acc + ((u >> (8 * k)) & 0xFF).to(torch.float32)
    return acc


def take_select_i32(w, idx, sel):
    """sel ? w[r, idx[r, c]] : w[r, c] on int32 words
    (nan_take_probe's k_i32)."""
    return torch.where(sel, torch.take_along_dim(w, idx.long(), 1), w)


def take_select_f32(w, idx, sel):
    """take_select_i32 through float32: the words viewed as floats,
    gathered and selected as floats, viewed back (nan_take_probe's
    k_f32). Bitwise equal to take_select_i32 when no step quiets a NaN."""
    wf = w.view(torch.float32)
    g = torch.take_along_dim(wf, idx.long(), 1)
    return torch.where(sel, g, wf).view(torch.int32)


# in the order of csrc/probes.cu's Probe enum (ops/cuda_probes.py numbers
# the kernels by it)
PLAIN = {f.__name__: f for f in (taa_i32_axis1, taa_i32_axis0,
                                 dyn_lane_shift, unpack4_static,
                                 take_select_i32, take_select_f32)}
PROBES = tuple(PLAIN)


def run(name: str, *args):
    """Probe `name` on its [8, 128] arguments: the kernel for CUDA
    tensors (ops/cuda_probes.py), the plain version for CPU tensors."""
    if name not in PLAIN:
        raise ValueError(f"probe must be one of {PROBES}, got {name!r}")
    if args[0].is_cuda:
        from acmmp_tpu_torch.ops import cuda_probes

        return cuda_probes.probe_cuda(name, *args)
    return PLAIN[name](*args)


def numpy_reference(name, w, idx, shift, sel):
    """The probe `name` in numpy, on [8, 128] int32 words `w`, lane
    indices `idx`, shifts `shift` and a bool selector `sel` (the formulas
    of tools/mosaic_probe.py:70-75 for the lane gather and the shift)."""
    u = w.view(np.uint32)
    if name == "taa_i32_axis1":
        return np.take_along_axis(w, idx, axis=1)
    if name == "taa_i32_axis0":
        return np.take_along_axis(w, idx % ROWS, axis=0)
    if name == "dyn_lane_shift":
        return ((u >> shift) & 0xFF).astype(np.float32)
    if name == "unpack4_static":
        acc = np.zeros(w.shape, np.float32)
        for k in range(4):
            acc = acc + ((u >> (8 * k)) & 0xFF).astype(np.float32)
        return acc
    gathered = np.take_along_axis(w, idx, axis=1)
    if name == "take_select_i32":
        return np.where(sel, gathered, w)
    if name == "take_select_f32":
        return np.where(sel, gathered.view(np.float32),
                        w.view(np.float32)).view(np.int32)
    raise ValueError(f"unknown probe {name!r}")
