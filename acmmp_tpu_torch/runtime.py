"""Device and dtype policy of the PyTorch port.

Everything is float32 as the JAX package computes it: its camera einsums
run at ``Precision.HIGHEST``, so TF32 stays off for matrix products and
convolutions alike. Entry points run on CUDA unless the caller passes
``device="cpu"`` (the CPU tests do)."""

from __future__ import annotations

import torch

DTYPE = torch.float32
DEFAULT_DEVICE = "cuda"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless told otherwise. A
    CUDA request on a machine without a card raises rather than falling
    back to the CPU."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "acmmp_tpu_torch: CUDA requested but no CUDA device is "
            "available; pass device='cpu' to run the plain version")
    return dev

