"""acmmp_tpu_torch — the PyTorch/CUDA port of acmmp_tpu.

It keeps acmmp_tpu's module layout and names so each function's
counterpart is easy to find, imports nothing of the JAX package, and runs
its hot op, the warped bilateral ZNCC, through a hand-written CUDA kernel
(csrc/zncc.cu) on CUDA tensors. Entry points run on CUDA unless the
caller passes ``device="cpu"``.

Ported so far: the photometric single-view PatchMatch solve
(engine/patchmatch.py::run_patchmatch with Mode())."""

from acmmp_tpu_torch import runtime  # noqa: F401  (sets the f32/TF32 policy)
from acmmp_tpu_torch.config import PatchMatchParams

__all__ = ["PatchMatchParams", "runtime"]
