"""[The benchmark's plain reference: a frozen copy of the program's
`acmmp_tpu_torch/ops/pixel_rng.py`, its plain (non-kernel) path only, importing
nothing of the program. Its original text follows.]

Per-pixel counter-based RNG keyed on GLOBAL pixel coordinates — the port
of ``acmmp_tpu/ops/pixel_rng.py``, bit for bit.

Every draw is a pure function of (key words, global y, global x, salt):
a murmur3 fmix32 chain. PyTorch's uint32 arithmetic is incomplete, so the
chain runs in int64 and keeps the low 32 bits after every multiply and
add; multiplies are split into 16-bit halves so no int64 product
overflows. Coordinates convert as ``astype(int32).astype(uint32)`` does
(truncation toward zero, negatives wrap).

A ``KeyBatch`` of B keys draws a [B, *grid] field, each view the field of
its own key."""

from __future__ import annotations

import torch

from h100bench.reference.keys import AnyKey, KeyBatch

_M32 = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLD = 0x9E3779B9


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 `a` in [0, 2^32) and a 32-bit constant."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 finalizer."""
    h = h ^ (h >> 16)
    h = _mul32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C2)
    return h ^ (h >> 16)


def _u32(coord) -> torch.Tensor:
    c = torch.as_tensor(coord)
    return c.to(torch.int32).to(torch.int64) & _M32


def bits(key: AnyKey, y, x, salt: int) -> torch.Tensor:
    """Hash per pixel as int64 in [0, 2^32); y/x are (possibly float)
    global coordinate grids ([B, *grid] for a KeyBatch)."""
    yi, xi = _u32(y), _u32(x)
    if isinstance(key, KeyBatch):
        k0, k1 = key.words_on(xi.device)
    else:
        k0, k1 = key.k0, key.k1
    h = _fmix((_mul32(xi, _GOLD) + k0) & _M32)
    h = _fmix(h ^ ((_mul32(yi, _C1) + k1) & _M32))
    return _fmix(h ^ ((salt * _GOLD) & _M32))


def uniform(key: AnyKey, y, x, salt: int) -> torch.Tensor:
    """float32 U[0, 1) per pixel (24-bit mantissa resolution)."""
    return (bits(key, y, x, salt) >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform_n(key: AnyKey, y, x, salt: int, n: int) -> torch.Tensor:
    """[n, *grid] independent U[0, 1) fields (salt+i per sample)."""
    return torch.stack([uniform(key, y, x, salt + i) for i in range(n)])


def sphere_direction(key: AnyKey, y, x, salt: int) -> torch.Tensor:
    """[..., 3] uniform on the unit sphere: z ~ U(-1,1), phi ~ U(0,2pi)
    (GenerateRandomNormal's law, ACMMP.cu:170-196)."""
    z = uniform(key, y, x, salt) * 2.0 - 1.0
    phi = uniform(key, y, x, salt + 1) * (2.0 * torch.pi)
    s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([s * torch.cos(phi), s * torch.sin(phi), z], dim=-1)
