"""Planar-prior construction: support points, Delaunay triangulation,
per-triangle plane fit and rasterization — the port's copy of
``acmmp_tpu/engine/priors.py`` (numpy and scipy only), kept here so the
port imports nothing of the JAX package.

Host-side (runs once per view between two solver passes, outside the hot
jit), re-designing GetSupportPoints (src/ACMMP.cpp:868-894),
DelaunayTriangulation (:896-918, cv::Subdiv2D there, scipy.spatial here),
GetPriorPlaneParams (:920-953, cv::SVD::solveZ there, numpy lstsq/svd here)
and the triangle rasterization in ProcessProblem
(src/acmmp_definitions.cpp:332-374; we rasterize with Delaunay.find_simplex
instead of barycentric stepping, which the reference does approximately)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from acmmp_tpu_torch.io.dense_folder import NumpyCamera


def get_support_points(costs: np.ndarray, step: int = 5,
                       max_cost: float = 2.0, accept_cost: float = 0.1,
                       width: Optional[int] = None,
                       height: Optional[int] = None) -> np.ndarray:
    """Min-cost pixel per step x step cell, kept if its cost < accept_cost.
    Returns [N, 2] integer (x, y) points."""
    H, W = costs.shape
    if width is not None:
        W = min(W, width)
    if height is not None:
        H = min(H, height)
    c = costs[:H, :W]
    pts = []
    for r0 in range(0, H, step):
        for c0 in range(0, W, step):
            cell = c[r0:r0 + step, c0:c0 + step]
            idx = np.argmin(cell)
            rr, cc = np.unravel_index(idx, cell.shape)
            if cell[rr, cc] < accept_cost:
                pts.append((c0 + cc, r0 + rr))
    return np.asarray(pts, np.int32).reshape(-1, 2)


def fit_triangle_plane(cam: NumpyCamera, depths: np.ndarray,
                       tri_xy: np.ndarray) -> np.ndarray:
    """Least-squares plane through the three vertices' camera-frame points
    (GetPriorPlaneParams, ACMMP.cpp:920-953). tri_xy: [3, 2] pixel coords.
    Returns plane 4-vector (n, w) with w >= 0."""
    fx, fy = cam.K[0, 0], cam.K[1, 1]
    cx, cy = cam.K[0, 2], cam.K[1, 2]
    A = np.ones((3, 4), np.float64)
    for k in range(3):
        x, y = tri_xy[k]
        d = depths[int(y), int(x)]
        A[k, 0] = d * (x - cx) / fx
        A[k, 1] = d * (y - cy) / fy
        A[k, 2] = d
    # solveZ: right singular vector of the smallest singular value
    _, _, vt = np.linalg.svd(A)
    n4 = vt[-1]
    norm = np.linalg.norm(n4[:3])
    if n4[3] < 0:
        norm = -norm
    return (n4 / norm).astype(np.float32)


def build_planar_prior(cam: NumpyCamera, depths: np.ndarray,
                       costs: np.ndarray, depth_min: float, depth_max: float,
                       width: int, height: int,
                       step: int = 5) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Full planar-prior construction for one view.

    Returns (prior_planes [H, W, 4], prior_mask [H, W] bool) over the padded
    depth-array shape, or (None, None) when too few support points exist."""
    from scipy.spatial import Delaunay

    pts = get_support_points(costs, step=step, width=width, height=height)
    if len(pts) < 4:
        return None, None
    try:
        tri = Delaunay(pts.astype(np.float64))
    except Exception:
        return None, None

    planes = np.zeros((len(tri.simplices), 4), np.float32)
    ok = np.zeros(len(tri.simplices), bool)
    for t, simplex in enumerate(tri.simplices):
        tri_xy = pts[simplex]
        planes[t] = fit_triangle_plane(cam, depths, tri_xy)
        ok[t] = np.isfinite(planes[t]).all()

    H, W = costs.shape
    xs, ys = np.meshgrid(np.arange(width), np.arange(height))
    simplex_of = tri.find_simplex(
        np.stack([xs.ravel(), ys.ravel()], axis=1).astype(np.float64)
    ).reshape(height, width)

    prior_planes = np.zeros((H, W, 4), np.float32)
    prior_mask = np.zeros((H, W), bool)
    inside = simplex_of >= 0
    sidx = np.where(inside, simplex_of, 0)
    tri_planes = planes[sidx]                     # [h, w, 4]
    prior_planes[:height, :width][inside] = tri_planes[inside]
    prior_mask[:height, :width] = inside & ok[sidx]

    # reject pixels whose prior depth falls outside the (relaxed) range
    # (acmmp_definitions.cpp:361-373)
    fx, fy = cam.K[0, 0], cam.K[1, 1]
    cx, cy = cam.K[0, 2], cam.K[1, 2]
    p = prior_planes[:height, :width]
    denom = ((xs - cx) * p[..., 0] + (fx / fy) * (ys - cy) * p[..., 1]
             + fx * p[..., 2])
    with np.errstate(divide="ignore", invalid="ignore"):
        d = -p[..., 3] * fx / denom
    good = np.isfinite(d) & (d >= depth_min) & (d <= depth_max)
    prior_mask[:height, :width] &= good
    return prior_planes, prior_mask
