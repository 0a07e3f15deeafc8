"""The port's hand-written CUDA kernels: build-and-load (see _build.py) and
the argument checks their wrappers (ops/cuda_*.py) share."""

import ctypes
import numbers

# the largest batch of one launch (kMaxBatch of csrc/zncc.cu and geom.cu)
MAX_BATCH = 256


def hypothesis_stack(kernel: str, planes, supported_k, batched=False):
    """(planes as a [K, Hg, W, 4] stack, whether the caller passed one
    [Hg, W, 4] field); with `batched`, a [K, B, Hg, W, 4] stack from
    [K, B, Hg, W, 4] or one [B, Hg, W, 4] field. Raises on a CPU tensor,
    another layout or a K the kernel was not built for."""
    if not planes.is_cuda:
        raise RuntimeError(f"{kernel} kernel: planes must be a CUDA tensor "
                           "(CPU tensors take ncc_backend='auto' or 'plain')")
    rank = 5 if batched else 4
    single = planes.ndim == rank - 1
    if single:
        planes = planes[None]
    if planes.ndim != rank or planes.shape[-1] != 4:
        want = "[K, B, Hg, W, 4]" if batched else "[K, Hg, W, 4]"
        raise ValueError(f"{kernel} kernel: planes must be {want}, got "
                         f"{tuple(planes.shape)}")
    if planes.shape[0] not in supported_k:
        raise ValueError(f"{kernel} kernel: K={planes.shape[0]} not in "
                         f"{supported_k}")
    return planes, single


def view_counts(kernel: str, n_views, B: int, V: int):
    """The true source count of each of a batch's B views, as the host
    int array the kernels take in their parameters: `n_views` is a host
    int for every view, a sequence of B host ints, or None for V."""
    counts = ([V] * B if n_views is None
              else [int(n_views)] * B if isinstance(n_views, numbers.Integral)
              else [int(n) for n in n_views])
    if len(counts) != B or not all(0 <= n <= V for n in counts):
        raise ValueError(f"{kernel} kernel: n_views {n_views} for {B} "
                         f"views of {V} source slots")
    if B > MAX_BATCH:
        raise ValueError(f"{kernel} kernel: a batch of {B} views, more than "
                         f"{MAX_BATCH}")
    return (ctypes.c_int * B)(*counts)


def check_arg(kernel: str, name: str, t, dtype, shape, device) -> None:
    """Raise unless tensor `t` has the device, dtype, shape and contiguous
    layout the kernel reads."""
    if t.device != device:
        raise ValueError(f"{kernel} kernel: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel} kernel: {name} is {t.dtype}, expected "
                        f"{dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel} kernel: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel} kernel: {name} must be contiguous")
