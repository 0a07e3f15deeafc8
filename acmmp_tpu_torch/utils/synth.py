"""Synthetic scenes with known geometry — the port's copy of
``look_at_camera``, ``textured_plane_scene``, ``textured_relief_scene`` and
``relief_gt_points`` from ``acmmp_tpu/utils/synth.py`` (numpy only), and
``write_dense_folder``,
which puts a scene on disk as a dense folder. The scene is generated in memory
with an analytic texture, so every view is photo-consistent by
construction and PatchMatch must recover the exact plane depth."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np
from PIL import Image as PILImage

from acmmp_tpu_torch.io.dense_folder import (NumpyCamera, write_cam_txt,
                                             write_pair_txt)


def _map_views(view, n_views: int):
    """[view(i) for i in range(n_views)], rendered in parallel threads
    (numpy releases the GIL in its array loops); each view's arithmetic
    is that of a sequential loop, so the scene is too."""
    workers = max(1, min(n_views, os.cpu_count() or 1))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(view, range(n_views)))


def look_at_camera(eye, target, up=(0.0, 1.0, 0.0), f=120.0, width=64,
                   height=48, depth_min=1.0, depth_max=20.0) -> NumpyCamera:
    """Build a world->cam pinhole camera looking from `eye` at `target`.
    Camera convention: +z forward, +x right, +y down (image coords)."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    upv = np.asarray(up, dtype=np.float64)
    right = np.cross(fwd, upv)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)
    t = -R @ eye
    K = np.array(
        [[f, 0.0, (width - 1) / 2.0],
         [0.0, f, (height - 1) / 2.0],
         [0.0, 0.0, 1.0]]
    )
    return NumpyCamera(
        K=K.astype(np.float32), R=R.astype(np.float32), t=t.astype(np.float32),
        depth_min=depth_min, depth_max=depth_max, width=width, height=height,
    )


def textured_plane_scene(
    n_views=3, width=64, height=48, plane_z=5.0, seed=0, f=120.0,
    depth_min=2.0, depth_max=10.0, texture_scale=1.0,
) -> Tuple[List[np.ndarray], List[NumpyCamera], float]:
    """A fronto-parallel world plane z=plane_z with an analytic smooth random
    texture, viewed by n_views cameras near the origin looking down +z.
    `texture_scale` multiplies the texture's spatial frequencies (1: the
    JAX package's scene); at a large focal length the default texture is
    smooth across a whole patch. Returns (images, cams, plane_z)."""
    rng = np.random.default_rng(seed)
    n_waves = 24
    freqs = texture_scale * rng.uniform(0.3, 3.5, size=(n_waves, 2))
    phases = rng.uniform(0, 2 * np.pi, size=n_waves)
    amps = rng.uniform(0.3, 1.0, size=n_waves)

    def texture(xw, yw):
        val = np.zeros_like(xw)
        for k in range(n_waves):
            val += amps[k] * np.sin(freqs[k, 0] * xw + freqs[k, 1] * yw + phases[k])
        val = val - val.min()
        return 30.0 + 200.0 * val / max(val.max(), 1e-6)

    offsets = np.linspace(-0.25, 0.25, n_views)

    def view(i):
        # distinct, small y offsets: no camera pair is exactly axis-aligned,
        # so no source coordinate sits on a truncation tie across the image
        eye = np.array([offsets[i], 0.013 * i + 0.004 * (i % 2), 0.0])
        cam = look_at_camera(eye, eye + np.array([0.0, 0.0, 1.0]), f=f,
                             width=width, height=height,
                             depth_min=depth_min, depth_max=depth_max)
        xs, ys = np.meshgrid(np.arange(width, dtype=np.float64),
                             np.arange(height, dtype=np.float64))
        dirs_cam = np.stack(
            [(xs - cam.K[0, 2]) / cam.K[0, 0],
             (ys - cam.K[1, 2]) / cam.K[1, 1],
             np.ones_like(xs)], axis=-1)
        dirs_world = dirs_cam @ cam.R
        center = -cam.R.T @ cam.t
        s = (plane_z - center[2]) / dirs_world[..., 2]
        pw = center[None, None, :] + s[..., None] * dirs_world
        return texture(pw[..., 0], pw[..., 1]).astype(np.float32), cam

    images, cams = (list(a) for a in zip(*_map_views(view, n_views)))
    return images, cams, plane_z


def textured_relief_scene(
    n_views=4, width=96, height=64, base_z=5.0, amp=0.35, seed=0, f=140.0,
    depth_min=2.0, depth_max=10.0, spread=0.22, converge=False,
):
    """A smooth textured height-field surface z(x, y) = base_z +
    amp * (sin(1.1 x) * cos(0.9 y) + 0.5 sin(2.3 x + 1)) rendered
    analytically per view (Newton iteration along each ray), plus the
    ground-truth depth map of view 0. `spread` is the half-width of the
    camera baseline; with `converge` the cameras verge on (0, 0, base_z).
    Returns (images, cams, gt_depth0 [H, W])."""
    rng = np.random.default_rng(seed)
    n_waves = 24
    freqs = rng.uniform(0.5, 4.5, size=(n_waves, 2))
    phases = rng.uniform(0, 2 * np.pi, size=n_waves)
    amps = rng.uniform(0.3, 1.0, size=n_waves)

    def texture(xw, yw):
        val = np.zeros_like(xw)
        for k in range(n_waves):
            val += amps[k] * np.sin(freqs[k, 0] * xw + freqs[k, 1] * yw + phases[k])
        val = val - val.min()
        return 30.0 + 200.0 * val / max(val.max(), 1e-6)

    def z_surf(xw, yw):
        return base_z + amp * (np.sin(1.1 * xw) * np.cos(0.9 * yw)
                               + 0.5 * np.sin(2.3 * xw + 1.0))

    offsets = np.linspace(-spread, spread, n_views)

    def view(i):
        eye = np.array([offsets[i], 0.013 * i + 0.004 * (i % 2), 0.0])
        target = (np.array([0.0, 0.0, base_z]) if converge
                  else eye + np.array([0.0, 0.0, 1.0]))
        cam = look_at_camera(eye, target, f=f, width=width, height=height,
                             depth_min=depth_min, depth_max=depth_max)
        xs, ys = np.meshgrid(np.arange(width, dtype=np.float64),
                             np.arange(height, dtype=np.float64))
        dirs_cam = np.stack(
            [(xs - cam.K[0, 2]) / cam.K[0, 0],
             (ys - cam.K[1, 2]) / cam.K[1, 1],
             np.ones_like(xs)], axis=-1)
        dirs_world = dirs_cam @ cam.R
        center = -cam.R.T @ cam.t
        # Newton on s: center_z + s*dz - z_surf(x(s), y(s)) = 0
        s = (base_z - center[2]) / dirs_world[..., 2]
        for _ in range(25):
            p = center[None, None, :] + s[..., None] * dirs_world
            g = p[..., 2] - z_surf(p[..., 0], p[..., 1])
            s = s - 0.8 * g / dirs_world[..., 2]
        p = center[None, None, :] + s[..., None] * dirs_world
        # depth = z-coordinate in the camera frame
        gt = (((p - center) @ cam.R.T)[..., 2].astype(np.float32) if i == 0
              else None)
        return texture(p[..., 0], p[..., 1]).astype(np.float32), cam, gt

    images, cams, gts = (list(a) for a in zip(*_map_views(view, n_views)))
    return images, cams, gts[0]


def relief_gt_points(cams, width, height, base_z=5.0, amp=0.35,
                     samples=(960, 1280)):
    """Dense analytic ground-truth points of the relief surface
    (textured_relief_scene's z_surf law) over every view's frustum
    footprint — the GT side of the DTU-protocol quality artifacts
    (tools/fullscale_quality.py). Per-view Newton ray casts of
    samples = (rows, cols) rays, concatenated; eval reduce_points dedups
    the overlap."""

    def z_surf(xw, yw):
        return base_z + amp * (np.sin(1.1 * xw) * np.cos(0.9 * yw)
                               + 0.5 * np.sin(2.3 * xw + 1.0))

    def one(cam):
        xs = np.linspace(0, width - 1, samples[1])
        ys = np.linspace(0, height - 1, samples[0])
        Xg, Yg = np.meshgrid(xs, ys)
        dirs = np.stack([(Xg - cam.K[0, 2]) / cam.K[0, 0],
                         (Yg - cam.K[1, 2]) / cam.K[1, 1],
                         np.ones_like(Xg)], axis=-1)
        dirs_w = dirs @ cam.R
        center = -cam.R.T @ cam.t
        s = (base_z - center[2]) / dirs_w[..., 2]
        for _ in range(30):
            p = center[None, None] + s[..., None] * dirs_w
            g = p[..., 2] - z_surf(p[..., 0], p[..., 1])
            s = s - 0.8 * g / dirs_w[..., 2]
        return (center[None, None] + s[..., None] * dirs_w).reshape(-1, 3)

    return np.concatenate(_map_views(lambda i: one(cams[i]), len(cams)))


def write_dense_folder(dense: str, images, cams) -> str:
    """Write a dense folder (images/%08d.jpg at JPEG quality 98,
    cams/%08d_cam.txt and a pair.txt in which every other view is a
    source with score 100) — the port's copy of the helper of
    tests/test_pipeline.py. Returns `dense`."""
    os.makedirs(os.path.join(dense, "images"), exist_ok=True)
    os.makedirs(os.path.join(dense, "cams"), exist_ok=True)
    n = len(images)
    pairs = []
    for i in range(n):
        PILImage.fromarray(np.clip(images[i], 0, 255).astype(np.uint8)).save(
            os.path.join(dense, "images", f"{i:08d}.jpg"), quality=98)
        write_cam_txt(os.path.join(dense, "cams", f"{i:08d}_cam.txt"),
                      cams[i])
        pairs.append((i, [(j, 100.0) for j in range(n) if j != i]))
    write_pair_txt(os.path.join(dense, "pair.txt"), pairs)
    return dense
