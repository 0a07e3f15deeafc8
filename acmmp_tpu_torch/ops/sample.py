"""Multi-channel 2D map sampling (nearest) — the port of
``acmmp_tpu/ops/sample.py``: the plain version and the dispatch.

Fusion projects every reference pixel into each source view and reads the
source depth/normal maps at the rounded integer coordinates
(src/acmmp_definitions.cpp:938-966). ``gather2d_sample`` reads them
through the hand-written CUDA kernel (ops/cuda_sample.py, csrc/sample.cu)
for CUDA tensors and through the plain version below for CPU tensors.
There is no fallback: with backend "auto" or "cuda" a CUDA tensor
launches the kernel or raises, and "cuda" on a CPU tensor raises.

Contract: `maps[v, c]` sampled at `(rr[v], cc[v])` where `valid[v]`,
zeros elsewhere. Valid lanes must carry in-range indices (callers clip);
invalid lanes may hold garbage — they are never read. Both routes move
whole f32 words with no arithmetic, so they are bitwise equal.
"""

from __future__ import annotations

import torch

BACKENDS = ("auto", "plain", "cuda")


def gather2d(maps: torch.Tensor, rr: torch.Tensor, cc: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """The plain version: `maps` [V, C, Hs, Ws] sampled at (`rr`, `cc`)
    [V, H, W] where `valid`, else 0. Returns [V, C, H, W]. Invalid lanes
    read index 0, so their indices are never used."""
    V, C, Hs, Ws = maps.shape
    H, W = rr.shape[1:]
    idx = torch.where(valid, rr.long() * Ws + cc.long(), 0)
    out = torch.take_along_dim(maps.reshape(V, C, Hs * Ws),
                               idx.reshape(V, 1, H * W), dim=2)
    return torch.where(valid[:, None], out.reshape(V, C, H, W), 0.0)


def gather2d_sample(maps: torch.Tensor, rr: torch.Tensor, cc: torch.Tensor,
                    valid: torch.Tensor, backend: str = "auto"
                    ) -> torch.Tensor:
    """Dispatch: the CUDA kernel for CUDA tensors ("auto") or always
    ("cuda"; raises on CPU tensors), the plain version for CPU tensors
    ("auto") or always ("plain", the kernel's yardstick). Same contract
    as `gather2d`."""
    if backend not in BACKENDS:
        raise ValueError(f"sample_backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    if backend == "cuda" or (backend == "auto" and maps.is_cuda):
        from acmmp_tpu_torch.ops import cuda_sample

        return cuda_sample.gather2d_cuda(maps, rr, cc, valid)
    return gather2d(maps, rr, cc, valid)
