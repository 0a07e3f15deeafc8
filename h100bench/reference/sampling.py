"""[The benchmark's plain reference: a frozen copy of the program's
`acmmp_tpu_torch/ops/sampling.py`, its plain (non-kernel) path only, importing
nothing of the program. Its original text follows.]

Counter-based random plane-hypothesis sampling — the port of
``acmmp_tpu/ops/sampling.py``.

Every draw is a pure function of (key, global pixel, salt) through
ops/pixel_rng.py, so the same key gives the same field in any layout
(full grid or parity-packed half grid). Laws, as in the JAX package:
  * random unit normals: uniform on the facing hemisphere (``min_cos=0``,
    the reference's GenerateRandomNormal, ACMMP.cu:170-196) or uniform on
    the cap ``dot(n, -view_dir) >= min_cos`` (DEVIATIONS.md #19);
  * random depths: uniform on the full range (``tile_window=0``) or inside
    a random subrange of fraction f per (16, 128) GLOBAL pixel tile
    (DEVIATIONS.md #18);
  * perturbed normals: three U(-p/2, p/2) Euler angles, keeping the
    original when the result faces away (ACMMP.cu:198-233).
A ``KeyBatch`` with a camera of [B, 1, 1] fields (geometry.insert_dims)
and depth ranges of [B, 1, 1] draws every view's field at once.
"""

from __future__ import annotations

import math

import torch

from h100bench.reference import geometry as geo
from h100bench.reference import keys
from h100bench.reference import pixel_rng as prng

# window tile of the windowed depth law, in GLOBAL pixels
WINDOW_TILE_ROWS = 16
WINDOW_TILE_COLS = 128


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def random_unit_normal(key: keys.AnyKey, cam: geo.Camera, x, y, depth,
                       min_cos: float = 0.0) -> torch.Tensor:
    """Random normals facing the camera; shapes follow x/y."""
    if not min_cos:
        n = prng.sphere_direction(key, y, x, 0)
        return geo.face_camera(cam, x, y, depth, n)
    c = float(min_cos)
    a = -geo.view_direction(cam, x, y, depth)          # cap axis (unit)
    # uniform on the cap: cos(theta) ~ U(c, 1), phi ~ U(0, 2pi)
    ct = c + prng.uniform(key, y, x, 0) * (1.0 - c)
    ct = ct.expand(torch.broadcast_shapes(ct.shape, a.shape[:-1]))
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    phi = prng.uniform(key, y, x, 1) * (2.0 * math.pi)
    # orthonormal basis perpendicular to a (guard the degenerate helper)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=a.dtype, device=a.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=a.dtype, device=a.device)
    h = torch.where(torch.abs(a[..., :1]) < 0.9, ex, ey)
    e1 = _unit(torch.linalg.cross(a, h, dim=-1))
    e2 = torch.linalg.cross(a, e1, dim=-1)
    n = (ct[..., None] * a
         + (st * torch.cos(phi))[..., None] * e1
         + (st * torch.sin(phi))[..., None] * e2)
    return _unit(n)


def random_depth(key: keys.AnyKey, depth_min, depth_max, y, x,
                 tile_window: float = 0.0) -> torch.Tensor:
    """Per-pixel uniform depth draw (global-coordinate keyed); with
    ``tile_window = f`` each (16, 128) global tile draws inside its own
    random subrange of fraction f of the range."""
    u = prng.uniform(key, y, x, 2)
    if tile_window:
        f = float(tile_window)
        ty = torch.floor(y * (1.0 / WINDOW_TILE_ROWS))
        tx = torch.floor(x * (1.0 / WINDOW_TILE_COLS))
        w0 = prng.uniform(key, ty, tx, 3) * (1.0 - f)
        u = w0 + u * f
    return u * (depth_max - depth_min) + depth_min


def random_plane(key: keys.AnyKey, cam: geo.Camera, x, y, depth_min,
                 depth_max, tile_window: float = 0.0,
                 min_cos: float = 0.0) -> torch.Tensor:
    """GenerateRandomPlaneHypothesis (ACMMP.cu:235-241)."""
    kd, kn = keys.split(key)
    depth = random_depth(kd, depth_min, depth_max, y, x, tile_window)
    n = random_unit_normal(kn, cam, x, y, depth, min_cos=min_cos)
    return geo.plane_from_depth_normal(cam, x, y, depth, n)


def _euler_rotation(a1, a2, a3) -> torch.Tensor:
    """Rotation matrix rows per GeneratePerturbedNormal (ACMMP.cu:213-222)."""
    s1, s2, s3 = torch.sin(a1), torch.sin(a2), torch.sin(a3)
    c1, c2, c3 = torch.cos(a1), torch.cos(a2), torch.cos(a3)
    r = torch.stack([
        c2 * c3, c3 * s1 * s2 - c1 * s3, s1 * s3 + c1 * c3 * s2,
        c2 * s3, c1 * c3 + s1 * s2 * s3, c1 * s2 * s3 - c3 * s1,
        -s2, c2 * s1, c1 * c2,
    ], dim=-1)
    return r.reshape(r.shape[:-1] + (3, 3))


def perturbed_normal(key: keys.AnyKey, cam: geo.Camera, x, y, normal,
                     perturbation) -> torch.Tensor:
    """Rotate `normal` by three small random Euler angles; keep the original
    where the perturbed normal faces away from the camera."""
    angles = (prng.uniform_n(key, y, x, 4, 3) - 0.5) * perturbation
    R = _euler_rotation(angles[0], angles[1], angles[2])
    rotated = (R * normal[..., None, :]).sum(-1)
    vd = geo.view_direction(cam, x, y, 1.0)
    bad = (rotated * vd).sum(-1, keepdim=True) >= 0.0
    return _unit(torch.where(bad, normal, rotated))
