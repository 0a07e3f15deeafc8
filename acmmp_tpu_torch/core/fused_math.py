"""Float32 arithmetic that rounds as the JAX package's compiled fusion
program does on the CPU (XLA:CPU on an x86-64 host with FMA).

XLA:CPU lowers the fusion program (``acmmp_tpu/engine/fusion.py``) to LLVM
with floating-point contraction allowed, so every multiply whose only use
is an add becomes one fused multiply-add, rounded once; its exp is an
inlined Cephes polynomial (itself contracted), and its atan2 is a call to
the C library's ``atan2f`` (glibc's, the fdlibm algorithm, every
operation rounded). Eager torch rounds each product, and its exp and
atan2 are other approximations, so a pixel near a fusion threshold could
be accepted by one package and not by the other. The functions here
compute those steps bit for bit, with plain tensor ops, so they give the
same bits on the CPU and on the card:

  * ``fma(a, b, c)`` is a*b + c rounded once to float32. The product of
    two float32 values is exact in float64 (48 of 53 bits); the float64
    sum is rounded to odd (its TwoSum error decides the last bit), and a
    value rounded to odd with at least 2*24 + 2 bits rounds to the
    nearest float32 exactly as the exact sum would (Boldo and Melquiond,
    "Emulation of FMA and correctly rounded sums", IEEE TC 2008).
  * ``sqrt(x)`` is the correctly rounded square root (as the SSE/AVX
    instruction gives it): the float64 root of a float32 value rounds to
    the float32 root (53 >= 2*24 + 2 bits). torch's CPU float32 sqrt is
    not correctly rounded on every value.
  * ``exp(x)`` is XLA:CPU's float32 exp; ``acos(x)`` is its lowering,
    ``atan2(sqrt((1 - x)(1 + x)), x)`` on glibc's ``atan2f``.

On a host without FMA, XLA:CPU contracts nothing and the JAX package's
results differ from these in the last bit; with AVX-512 its 3x3 products
of a point by a matrix transpose (``cam_to_world``) keep two of three
components unfused (ROADMAP.md, rule "Fusion rounds as the JAX
package's compiled program")."""

from __future__ import annotations

import numpy as np
import torch


def _f32(v: float) -> float:
    """v rounded to float32, as a Python float: torch converts it to a
    float32 operand exactly, with no tensor of its own (and so no copy to
    the device)."""
    return float(np.float32(v))


def fma(a, b, c) -> torch.Tensor:
    """a * b + c in float32, rounded once (see the module docstring); an
    infinite or NaN term gives what an IEEE fma gives."""
    a, b, c = (v.float() if isinstance(v, torch.Tensor) else _f32(v)
               for v in (a, b, c))
    # float64 arithmetic; a float32 operand widens exactly inside the op
    p = a.double() * b if isinstance(a, torch.Tensor) else a * b.double()
    s = p + c                              # p exact
    bv = s - p
    err = (p - (s - bv)) + (c - bv)        # TwoSum: s + err == p + c exactly
    bits = s.view(torch.int64)
    # round to odd: an inexact finite sum with an even last bit moves one
    # unit toward the exact value (where s is infinite, err is NaN)
    odd = bits + torch.where((err > 0) == (s > 0), 1, -1)
    fix = (err != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    return torch.where(fix, odd, bits).view(torch.float64).float()


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root."""
    return torch.sqrt(x.double()).float()


def dot3(a, b) -> torch.Tensor:
    """sum_j a[..., j] * b[..., j] over a last axis of 3, as XLA:CPU's
    small dot and reduce loops contract it: fma(a2, b2, fma(a1, b1,
    a0 * b0))."""
    return fma(a[..., 2], b[..., 2],
               fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def matvec(M, v) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) -> (..., 3), each row a ``dot3``."""
    return dot3(M, v[..., None, :])


# XLA:CPU's float32 exp (Cephes): e^x = e^r * 2^n with n = floor(x log2(e)
# + 1/2) and r = x - n log(2) in two parts; constants as float32.
_EXP_C1 = _f32(0.693359375)
_EXP_C2 = _f32(-2.12194440e-4)
_EXP_P = tuple(_f32(v) for v in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))


def exp(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, -87.8, 88.8)
    n = torch.floor(fma(x, 1.44269504088896341, 0.5)).clamp(-127.0, 127.0)
    r = fma(-_EXP_C1, n, x)
    r = fma(-_EXP_C2, n, r)
    z = fma(r, _EXP_P[0], _EXP_P[1])
    for p in _EXP_P[2:]:
        z = fma(z, r, p)
    z = 1.0 + fma(z, r * r, r)
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return z * pow2


# glibc's atanf / atan2f (sysdeps/ieee754/flt-32, from fdlibm)
_ATAN_HI = tuple(_f32(v) for v in (
    4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01, 1.5707962513e+00))
_ATAN_LO = tuple(_f32(v) for v in (
    5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08, 7.5497894159e-08))
_AT = tuple(_f32(v) for v in (
    3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01,
    -1.1111110449e-01, 9.0908870101e-02, -7.6918758452e-02,
    6.6610731184e-02, -5.8335702866e-02, 4.9768779427e-02,
    -3.6531571299e-02, 1.6285819933e-02))
_PI = _f32(3.1415927410e+00)
_PI_LO = _f32(-8.7422776573e-08)
_PI_O_2 = _f32(1.5707963705e+00)
# float32 sums of the constants above, as atanf and atan2f round them
_ATAN_INF = _f32(np.float32(_ATAN_HI[3]) + np.float32(_ATAN_LO[3]))
_ATAN2_BIG = _f32(np.float32(_PI_O_2) + np.float32(0.5 * _PI_LO))


def _atanf_nonneg(x: torch.Tensor) -> torch.Tensor:
    """glibc's atanf for x >= 0 (or NaN), every operation rounded."""
    ix = x.view(torch.int32)
    # argument reduction by range: id -1 keeps x
    r0 = (2.0 * x - 1.0) / (2.0 + x)               # [7/16, 11/16)
    r1 = (x - 1.0) / (x + 1.0)                     # [11/16, 19/16)
    r2 = (x - 1.5) / (1.0 + 1.5 * x)               # [19/16, 39/16)
    r3 = -1.0 / x                                  # [39/16, 2^25)
    idx = ((ix >= 0x3EE00000).int() + (ix >= 0x3F300000).int()
           + (ix >= 0x3F980000).int() + (ix >= 0x401C0000).int() - 1)
    xr = torch.where(idx < 0, x, torch.where(idx == 0, r0, torch.where(
        idx == 1, r1, torch.where(idx == 2, r2, r3))))
    z = xr * xr
    w = z * z
    s1 = torch.full_like(x, _AT[10])
    for k in (8, 6, 4, 2, 0):
        s1 = _AT[k] + w * s1
    s1 = z * s1
    s2 = torch.full_like(x, _AT[9])
    for k in (7, 5, 3, 1):
        s2 = _AT[k] + w * s2
    s2 = w * s2
    small = xr - xr * (s1 + s2)

    def pick(table):
        return torch.where(idx <= 0, table[0], torch.where(
            idx == 1, table[1], torch.where(idx == 2, table[2], table[3])))

    big = pick(_ATAN_HI) - ((xr * (s1 + s2) - pick(_ATAN_LO)) - xr)
    out = torch.where(idx < 0, small, big)
    # |x| >= 2^25: atan(inf) in two parts; |x| < 2^-29: x
    out = torch.where(ix >= 0x4C000000, _ATAN_INF, out)
    out = torch.where(ix < 0x31000000, x, out)
    return torch.where(torch.isnan(x), x, out)


def _atan2_nonneg_y(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """glibc's atan2f(y, x) for y >= 0 (or NaN) and finite x."""
    iy = y.view(torch.int32)
    ix = x.abs().view(torch.int32)
    k = (iy - ix) >> 23
    z = _atanf_nonneg((y / x).abs())
    z = torch.where(k > 60, _ATAN2_BIG, z)
    z = torch.where((x < 0) & (k < -60), 0.0, z)
    z = torch.where(x == 1.0, _atanf_nonneg(y), z)
    out = torch.where(x < 0, _PI - (z - _PI_LO), z)
    out = torch.where(y == 0, torch.where(x < 0, _PI, y), out)
    out = torch.where(x == 0, _PI_O_2, out)
    return torch.where(torch.isnan(x) | torch.isnan(y), x + y, out)


def acos(x: torch.Tensor) -> torch.Tensor:
    """XLA's acos, atan2(sqrt((1 - x)(1 + x)), x), on glibc's atan2f."""
    return _atan2_nonneg_y(sqrt((1.0 - x) * (1.0 + x)), x)
