"""Prior bootstrapping: sample per-view depth/normal priors from a fused
point cloud — the port's copy of
``acmmp_tpu/experiments/prior_sampler.py`` (host numpy; the PNGs go
through io/priors' codec, no OpenCV).

Public replacement for the reference harness's private
`abiStereoRaySampler.probaliblity_volume` (run_dtu_analysis.py:11,64-82 —
not in the repo): the harness reconstructs once, builds a density model of
the fused points, samples a depth/normal prior per camera, writes them as
16-bit PNGs (priors/{depths,normals}/%08d.png), and re-runs with `-p`.

This implementation renders the priors directly: splat the points into the
view with a z-buffer (closest-depth wins within each pixel and a small
splat radius), median-fill small holes, and take normals from the rendered
depth map's local plane fit — equivalent information to the density-volume
sample, with no private dependency."""

from __future__ import annotations

import numpy as np

from acmmp_tpu_torch.io.dense_folder import NumpyCamera
from acmmp_tpu_torch.io.priors import write_prior_pngs


def render_depth_from_points(
    points: np.ndarray,          # [N, 3] world
    cam: NumpyCamera,
    width: int,
    height: int,
    min_dist: float,
    max_dist: float,
    splat_radius: int = 1,
    fill_iters: int = 3,
) -> np.ndarray:
    """Z-buffer splat of the point cloud into the view. Returns [H, W]
    depth, 0 where nothing projects."""
    X = points @ cam.R.T + cam.t[None]
    z = X[:, 2]
    ok = (z > min_dist) & (z < max_dist)
    X = X[ok]
    z = z[ok]
    u = X[:, 0] / z * cam.K[0, 0] + cam.K[0, 2]
    v = X[:, 1] / z * cam.K[1, 1] + cam.K[1, 2]
    ui = np.round(u).astype(np.int64)
    vi = np.round(v).astype(np.int64)
    inb = (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
    ui, vi, z = ui[inb], vi[inb], z[inb]

    depth = np.full((height, width), np.inf, np.float32)
    # closest-point z-buffer (+ splat): np.minimum.at is the scatter-min
    for dy in range(-splat_radius, splat_radius + 1):
        for dx in range(-splat_radius, splat_radius + 1):
            uu = np.clip(ui + dx, 0, width - 1)
            vv = np.clip(vi + dy, 0, height - 1)
            np.minimum.at(depth, (vv, uu), z)
    depth[~np.isfinite(depth)] = 0.0

    # median hole-fill: replace empty pixels with the median of their valid
    # 3x3 neighbors, a few passes
    for _ in range(fill_iters):
        holes = depth == 0.0
        if not holes.any():
            break
        padded = np.pad(depth, 1, mode="constant")
        stack = np.stack([
            padded[1 + dy:1 + dy + height, 1 + dx:1 + dx + width]
            for dy in (-1, 0, 1) for dx in (-1, 0, 1)
        ])
        valid = stack > 0.0
        cnt = valid.sum(0)
        med = np.where(valid, stack, np.nan)
        with np.errstate(all="ignore"):
            med = np.nanmedian(med, axis=0)
        fill = holes & (cnt >= 3)
        depth[fill] = med[fill]
    return depth


def normals_from_depth(depth: np.ndarray, cam: NumpyCamera) -> np.ndarray:
    """Camera-frame normals from the rendered depth map via local plane
    gradients (cross product of the surface tangents), camera-facing."""
    H, W = depth.shape
    fx, fy = cam.K[0, 0], cam.K[1, 1]
    cx, cy = cam.K[0, 2], cam.K[1, 2]
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    X = np.stack([depth * (xs - cx) / fx, depth * (ys - cy) / fy, depth], -1)
    dx = np.gradient(X, axis=1)
    dy = np.gradient(X, axis=0)
    n = np.cross(dx.reshape(-1, 3), dy.reshape(-1, 3)).reshape(H, W, 3)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.divide(n, norm, out=np.zeros_like(n), where=norm > 1e-12)
    # face the camera: n . view_dir < 0
    vd = X / np.maximum(np.linalg.norm(X, axis=-1, keepdims=True), 1e-12)
    flip = np.sum(n * vd, axis=-1, keepdims=True) > 0
    n = np.where(flip, -n, n)
    n[depth == 0.0] = np.array([0.0, 0.0, -1.0])
    return n.astype(np.float32)


def write_priors_from_points(
    dense_folder: str,
    points: np.ndarray,
    cams: list,                   # list[NumpyCamera] with width/height set
) -> None:
    """Render and write priors/{depths,normals}/%08d.png for every view.

    Depths are encoded against each camera's own [depth_min, depth_max] so
    the seeded-init loader (io/priors.load_seed_planes decodes with the
    cam.txt range) round-trips exactly; normals are camera-frame, matching
    the loader's plane construction."""
    for i, cam in enumerate(cams):
        depth = render_depth_from_points(
            points, cam, cam.width, cam.height, cam.depth_min, cam.depth_max)
        n_cam = normals_from_depth(depth, cam)
        write_prior_pngs(dense_folder, i, depth, n_cam,
                         depth_min=cam.depth_min, depth_max=cam.depth_max)
