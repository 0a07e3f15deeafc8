"""acmmp_tpu_torch — the PyTorch/CUDA port of acmmp_tpu.

It keeps acmmp_tpu's module layout and names so each function's
counterpart is easy to find, imports nothing of the JAX package, and runs
the JAX package's Pallas kernels as hand-written CUDA kernels on CUDA
tensors: the warped bilateral ZNCC (csrc/zncc.cu), the geometric-
consistency cost (csrc/geom.cu) and fusion's sampler (csrc/sample.cu).
Entry points run on CUDA unless the caller passes ``device="cpu"``.

Ported so far: every solver mode, the multi-scale scheduler with the
.dmb disk contract, fusion, the DTU evaluation and experiment harness,
and every subcommand of the JAX package's CLI but ``--mesh``
(``python -m acmmp_tpu_torch.cli reconstruct <dense_folder>``)."""

from acmmp_tpu_torch import runtime  # noqa: F401  (sets the f32/TF32 policy)
from acmmp_tpu_torch.config import PatchMatchParams

__all__ = ["PatchMatchParams", "runtime"]
