"""The port's hand-written CUDA kernels: build-and-load (see _build.py) and
the argument checks their wrappers (ops/cuda_*.py) share."""


def hypothesis_stack(kernel: str, planes, supported_k):
    """(planes as a [K, Hg, W, 4] stack, whether the caller passed one
    [Hg, W, 4] field). Raises on a CPU tensor, another layout or a K the
    kernel was not built for."""
    if not planes.is_cuda:
        raise RuntimeError(f"{kernel} kernel: planes must be a CUDA tensor "
                           "(CPU tensors take ncc_backend='auto' or 'plain')")
    single = planes.ndim == 3
    if single:
        planes = planes[None]
    if planes.ndim != 4 or planes.shape[-1] != 4:
        raise ValueError(f"{kernel} kernel: planes must be [K, Hg, W, 4], "
                         f"got {tuple(planes.shape)}")
    if planes.shape[0] not in supported_k:
        raise ValueError(f"{kernel} kernel: K={planes.shape[0]} not in "
                         f"{supported_k}")
    return planes, single


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
