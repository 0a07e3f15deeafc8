"""[The benchmark's plain reference: a frozen copy of the program's
`acmmp_tpu_torch/core/geometry.py`, its plain (non-kernel) path only, importing
nothing of the program. Its original text follows.]

Camera geometry on tensors — the port of ``acmmp_tpu/core/geometry.py``.

Conventions are the JAX package's (the reference's cam.txt contract):
  * ``R`` rotates world -> camera, ``t`` is the translation of that map:
    ``x_cam = R @ X_world + t``; the camera centre is ``C = -R^T t``.
  * Plane hypotheses are 4-vectors ``(nx, ny, nz, w)`` in the reference
    camera frame with ``n . X + w = 0`` on the plane.
  * Pixel coordinates are zero-based; a float sample coordinate ``x`` maps
    to pixels ``floor(x)..floor(x)+1`` with bilinear weights ``frac(x)``.

The 3x3 products are written out as broadcast multiply-and-sum so they
run in full float32 on every device (no TF32, no library GEMM choice).

A batched solve stacks B reference cameras ([B] fields) and B stacks of
source cameras ([B, V]); ``insert_dims`` gives them the singleton axes
that let every function here broadcast them over [B, H, W] grids (and
[K, B, H, W] hypothesis stacks) as a scalar camera broadcasts over
[H, W].
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

DTYPE = torch.float32


@dataclasses.dataclass
class Camera:
    """A pinhole camera; every field is a float32 tensor and may carry
    leading batch dims (a stacked view axis). width/height are the true
    image bounds in pixels."""

    K: torch.Tensor          # (..., 3, 3)
    R: torch.Tensor          # (..., 3, 3) world -> cam
    t: torch.Tensor          # (..., 3)
    width: torch.Tensor      # (...,)
    height: torch.Tensor     # (...,)
    depth_min: torch.Tensor  # (...,)
    depth_max: torch.Tensor  # (...,)

    @staticmethod
    def from_numpy(K, R, t, width, height, depth_min, depth_max,
                   device=None) -> "Camera":
        f = lambda a: torch.as_tensor(np.array(a, np.float32),  # noqa: E731
                                      device=device)
        return Camera(f(K), f(R), f(t), f(width), f(height), f(depth_min),
                      f(depth_max))


def stack_cameras(cams) -> Camera:
    return Camera(*(torch.stack([getattr(c, f.name) for c in cams])
                    for f in dataclasses.fields(Camera)))


def index_camera(cam: Camera, i) -> Camera:
    """Camera `i` of a stacked camera (every field indexed on axis 0)."""
    return Camera(*(getattr(cam, f.name)[i]
                    for f in dataclasses.fields(Camera)))


_TRAILING = {"K": 2, "R": 2, "t": 1}


def insert_dims(cam: Camera, at: int, n: int) -> Camera:
    """`cam` with `n` singleton axes inserted at position `at` of its
    leading (batch) axes: a [B] camera with at=1, n=2 broadcasts over
    [B, H, W] grids; [B, V] source cameras with at=1, n=2 over
    [B, H, W, V] fields."""
    def one(t: torch.Tensor, trailing: int) -> torch.Tensor:
        lead = t.shape[:t.ndim - trailing]
        return t.reshape(lead[:at] + (1,) * n + lead[at:]
                         + t.shape[t.ndim - trailing:])

    return Camera(*(one(getattr(cam, f.name), _TRAILING.get(f.name, 0))
                    for f in dataclasses.fields(Camera)))


def matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) -> (..., 3), broadcasting batch dims."""
    return (M * v[..., None, :]).sum(-1)


def _matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) -> (..., 3, 3)."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


# ---------------------------------------------------------------------------
# basic transforms
# ---------------------------------------------------------------------------

def camera_center(cam: Camera) -> torch.Tensor:
    """World-space camera centre C = -R^T t (ACMMP.cpp:219-222)."""
    return -matvec(cam.R.transpose(-1, -2), cam.t)


def backproject(cam: Camera, x, y, depth) -> torch.Tensor:
    """Pixel (x, y) at `depth` -> point in this camera's frame
    (Get3DPoint, ACMMP.cu:123-128). Broadcasts over pixel arrays."""
    K = cam.K
    fx, cx = K[..., 0, 0], K[..., 0, 2]
    fy, cy = K[..., 1, 1], K[..., 1, 2]
    X = depth * (x - cx) / fx
    Y = depth * (y - cy) / fy
    return torch.stack(torch.broadcast_tensors(X, Y, depth), dim=-1)


def cam_to_world(cam: Camera, X_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame point -> world: R^T (X - t)
    (Get3DPointonWorld_cu, ACMMP.cu:480-504)."""
    return matvec(cam.R.transpose(-1, -2), X_cam - cam.t)


def world_point(cam: Camera, x, y, depth) -> torch.Tensor:
    return cam_to_world(cam, backproject(cam, x, y, depth))


def project(cam: Camera, X_world: torch.Tensor):
    """World point -> (pixel xy, depth)
    (ProjectonCamera_cu, ACMMP.cu:506-516)."""
    x_cam = matvec(cam.R, X_world) + cam.t
    h = matvec(cam.K, x_cam)
    depth = h[..., 2]
    return h[..., :2] / depth[..., None], depth


def view_direction(cam: Camera, x, y, depth=1.0) -> torch.Tensor:
    """Unit ray through pixel (GetViewDirection, ACMMP.cu:130-142)."""
    d = torch.as_tensor(depth, dtype=DTYPE, device=cam.K.device)
    X = backproject(cam, x, y, d)
    return X / torch.linalg.vector_norm(X, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# plane hypotheses
# ---------------------------------------------------------------------------

def dist_to_origin(cam: Camera, x, y, depth, normal) -> torch.Tensor:
    """Plane offset w for a plane with `normal` through the point at
    (x, y, depth) (GetDistance2Origin, ACMMP.cu:144-149)."""
    X = backproject(cam, x, y, depth)
    return -(normal * X).sum(-1)


def depth_from_plane(cam: Camera, plane: torch.Tensor, x, y) -> torch.Tensor:
    """Depth of the plane at pixel (x, y)
    (ComputeDepthfromPlaneHypothesis, ACMMP.cu:163-168)."""
    K = cam.K
    fx, cx = K[..., 0, 0], K[..., 0, 2]
    fy, cy = K[..., 1, 1], K[..., 1, 2]
    denom = ((x - cx) * plane[..., 0]
             + (fx / fy) * (y - cy) * plane[..., 1]
             + fx * plane[..., 2])
    return -plane[..., 3] * fx / denom


def plane_from_depth_normal(cam: Camera, x, y, depth, normal) -> torch.Tensor:
    """(depth, cam-frame normal) -> plane 4-vector."""
    w = dist_to_origin(cam, x, y, depth, normal)
    return torch.cat([normal, w[..., None]], dim=-1)


def normal_cam_to_world(cam: Camera, n: torch.Tensor) -> torch.Tensor:
    """(TransformNormal, ACMMP.cu:333-341): n_world = R^T n_cam."""
    return matvec(cam.R.transpose(-1, -2), n)


def normal_world_to_cam(cam: Camera, n: torch.Tensor) -> torch.Tensor:
    """(TransformNormal2RefCam, ACMMP.cu:343-351): n_cam = R n_world."""
    return matvec(cam.R, n)


def face_camera(cam: Camera, x, y, depth, normal) -> torch.Tensor:
    """Flip `normal` so it faces the camera at pixel (x, y)
    (GenerateRandomNormal tail, ACMMP.cu:187-194)."""
    vd = view_direction(cam, x, y, depth)
    dot = (normal * vd).sum(-1, keepdim=True)
    return torch.where(dot > 0.0, -normal, normal)


# ---------------------------------------------------------------------------
# plane-induced homography
# ---------------------------------------------------------------------------

def homography_coeffs(ref_cam: Camera, src_cam: Camera):
    """Per view-pair constants of the plane-induced homography

        H(plane) = K_s (R_rel - t_rel n^T / w) K_r^{-1}
                 = A - outer(B, K_r^{-T} n) / w

    with ``R_rel = R_s R_r^T`` and ``t_rel = R_s (C_r - C_s)``. Returns
    (A (..., 3, 3), B (..., 3), Kr_invT (..., 3, 3))."""
    R_rel = _matmul(src_cam.R, ref_cam.R.transpose(-1, -2))
    C_rel = camera_center(ref_cam) - camera_center(src_cam)
    t_rel = matvec(src_cam.R, C_rel)
    Kr_inv = torch.linalg.inv(ref_cam.K)
    A = _matmul(_matmul(src_cam.K, R_rel), Kr_inv)
    B = matvec(src_cam.K, t_rel)
    return A, B, Kr_inv.transpose(-1, -2)


# ---------------------------------------------------------------------------
# image sampling
# ---------------------------------------------------------------------------

def bilinear_sample(img: torch.Tensor, x, y, width=None,
                    height=None) -> torch.Tensor:
    """Bilinear sample `img` (H, W) at float pixel coords, clamped to the
    true bounds (width, height) — the JAX package's law (DEVIATIONS.md)."""
    H, W = img.shape[-2], img.shape[-1]
    w_max = torch.as_tensor(W if width is None else width, dtype=DTYPE,
                            device=img.device) - 1.0
    h_max = torch.as_tensor(H if height is None else height, dtype=DTYPE,
                            device=img.device) - 1.0
    x = torch.minimum(torch.clamp(x, min=0.0), w_max)
    y = torch.minimum(torch.clamp(y, min=0.0), h_max)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = x0.long()
    y0 = y0.long()
    x1 = torch.minimum(x0 + 1, w_max.long())
    y1 = torch.minimum(y0 + 1, h_max.long())
    v00 = img[..., y0, x0]
    v01 = img[..., y0, x1]
    v10 = img[..., y1, x0]
    v11 = img[..., y1, x1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def nearest_sample(img: torch.Tensor, x, y, width=None,
                   height=None) -> torch.Tensor:
    """Truncate-to-int read of `img` (..., H, W) at float coords, clamped
    to the true bounds (the reference reads depth maps as
    ``tex2D(depth, (int)x + 0.5, (int)y + 0.5)``, ACMMP.cu:528).
    NaN reads index 0 and the clamp is taken in float before truncating
    (pallas_geom.py:129-130): for finite coordinates that equals the JAX
    package's truncate-then-clip, and no index is formed from a NaN or an
    infinity, whose integer conversion torch and CUDA define differently."""
    xi, yi = nearest_index(img, x, y, width, height)
    return img[..., yi, xi]


def nearest_index(img: torch.Tensor, x, y, width=None, height=None):
    """The (column, row) int64 indices `nearest_sample` reads; `width` /
    `height` may be tensors that broadcast against x / y."""
    H, W = img.shape[-2], img.shape[-1]
    w_max = torch.as_tensor(W if width is None else width, dtype=DTYPE,
                            device=img.device) - 1.0
    h_max = torch.as_tensor(H if height is None else height, dtype=DTYPE,
                            device=img.device) - 1.0
    xi = torch.minimum(torch.clamp(torch.nan_to_num(x), min=0.0), w_max)
    yi = torch.minimum(torch.clamp(torch.nan_to_num(y), min=0.0), h_max)
    return xi.long(), yi.long()


def pixel_grid(height: int, width: int, device=None):
    """Integer pixel coordinate grids (x: columns, y: rows), float32."""
    y = torch.arange(height, dtype=DTYPE, device=device)[:, None]
    x = torch.arange(width, dtype=DTYPE, device=device)[None, :]
    return (x.expand(height, width).contiguous(),
            y.expand(height, width).contiguous())
