"""Headless metric visualization — the port's copy of
``acmmp_tpu/experiments/visualize.py``.

Replaces python_scripts/visualise_DTU_metrics.py / visualise_dtu_metrics_2.py
/ visualise_point_number.py (seaborn/pyvista there): accuracy/completeness
box+strip plots per method vs camera count, and per-method point-count
ratios, written as PNGs with the matplotlib Agg backend (no display).
matplotlib is imported by the functions that draw, so importing the
package does not need it."""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from acmmp_tpu_torch.eval.dtu import METRIC_NAMES
from acmmp_tpu_torch.eval.stats import MetricTable


def _pyplot():
    """matplotlib.pyplot on the Agg backend (no display)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_metric_vs_cams(table: MetricTable, metric: str, out_path: str,
                        title: Optional[str] = None) -> str:
    """Box + strip plot of one metric per method, grouped by camera count
    (the layout of visualise_dtu_metrics_2.py)."""
    plt = _pyplot()
    mi = METRIC_NAMES.index(metric)
    methods = table.methods()
    ncams = sorted({c for (_, _, c) in table.rows})
    fig, ax = plt.subplots(figsize=(1.8 * max(len(ncams), 1) + 2, 4.5))
    width = 0.8 / max(len(methods), 1)
    colors = plt.cm.tab10.colors
    for m_i, method in enumerate(methods):
        xs, ys = [], []
        for c_i, ncam in enumerate(ncams):
            vals = [v[mi] for (m, s, c), v in table.rows.items()
                    if m == method and c == ncam]
            if not vals:
                continue
            pos = c_i + (m_i - (len(methods) - 1) / 2) * width
            ax.boxplot([vals], positions=[pos], widths=width * 0.9,
                       patch_artist=True,
                       boxprops=dict(facecolor=colors[m_i % 10], alpha=0.4),
                       medianprops=dict(color="black"), showfliers=False)
            jitter = (np.random.default_rng(0).random(len(vals)) - 0.5) * width * 0.5
            ax.scatter(pos + jitter, vals, s=12, color=colors[m_i % 10],
                       zorder=3, label=method if c_i == 0 else None)
            xs.append(pos)
            ys.append(np.median(vals))
    ax.set_xticks(range(len(ncams)))
    ax.set_xticklabels([str(c) for c in ncams])
    ax.set_xlabel("number of cameras")
    ax.set_ylabel(metric)
    ax.set_title(title or metric)
    ax.legend(loc="best", fontsize=8)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_point_counts(counts: Dict[str, Dict[int, float]], out_path: str,
                      baseline_method: Optional[str] = None) -> str:
    """Per-method fused point counts vs camera count; with a baseline
    method, ratios against it (visualise_point_number.py)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    base = counts.get(baseline_method, None) if baseline_method else None
    for method, per_cam in sorted(counts.items()):
        ncams = sorted(per_cam)
        vals = [per_cam[c] / base[c] if base and c in base and base[c] > 0
                else per_cam[c] for c in ncams]
        ax.plot(ncams, vals, marker="o", label=method)
    ax.set_xlabel("number of cameras")
    ax.set_ylabel("points" + (f" / {baseline_method}" if base else ""))
    ax.legend(fontsize=8)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_cameras(cams, out_path: str, points: Optional[np.ndarray] = None,
                 axis_len: float = 0.5) -> str:
    """3D plot of camera positions and optical axes (+ optional point-cloud
    subsample) — the headless analog of display_dtu_cams.py's pyvista
    renderer. `cams` is a sequence of objects with .R and .t."""
    plt = _pyplot()
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    for i, cam in enumerate(cams):
        R = np.asarray(cam.R)
        t = np.asarray(cam.t)
        center = -R.T @ t
        axis = R[2] * axis_len          # optical axis in world coords
        ax.scatter(*center, color="tab:red", s=30)
        ax.quiver(*center, *axis, color="tab:blue", arrow_length_ratio=0.2)
        ax.text(*center, f" {i}", fontsize=8)
    if points is not None and len(points):
        sub = points[:: max(len(points) // 2000, 1)]
        ax.scatter(sub[:, 0], sub[:, 1], sub[:, 2], s=1, alpha=0.3,
                   color="gray")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_depth_map(depth: np.ndarray, out_path: str, cost=None) -> str:
    """Depth (and optional cost) image dump — the headless analog of the
    reference's DEBUG imshow windows (src/ACMMP.cu:1356-1376)."""
    plt = _pyplot()
    n = 2 if cost is not None else 1
    fig, axes = plt.subplots(1, n, figsize=(6 * n, 4.5))
    axes = np.atleast_1d(axes)
    d = np.asarray(depth)
    im = axes[0].imshow(np.where(d > 0, d, np.nan), cmap="turbo")
    fig.colorbar(im, ax=axes[0], shrink=0.8)
    axes[0].set_title("depth")
    if cost is not None:
        im = axes[1].imshow(np.asarray(cost), cmap="magma")
        fig.colorbar(im, ax=axes[1], shrink=0.8)
        axes[1].set_title("cost")
    for a in axes:
        a.set_axis_off()
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def render_cloud_screenshot(ply_path: str, out_path: str,
                            camera_position=None, width: int = 1024,
                            height: int = 768, point_size: int = 1,
                            background=(255, 255, 255)) -> str:
    """Software point-cloud screenshot (visualise_results.py:21-35
    equivalent; the reference renders through pyvista/VTK, which this image
    lacks — a numpy z-buffer splatter gives the same artifact).

    `camera_position` follows pyvista's convention:
    ((eye_xyz), (focal_point_xyz), (viewup_xyz)). Defaults to a 3/4 view
    framing the cloud's bounding box."""
    plt = _pyplot()
    from acmmp_tpu_torch.io import read_ply

    pts, _, cols = read_ply(ply_path)
    if len(pts) == 0:
        img = np.full((height, width, 3), background, np.uint8)
        plt.imsave(out_path, img)
        return out_path
    center = pts.mean(axis=0)
    extent = float(np.linalg.norm(pts.max(0) - pts.min(0)))
    if camera_position is None:
        eye = center + extent * np.asarray([0.7, -0.5, -0.9])
        camera_position = (tuple(eye), tuple(center), (0.0, -1.0, 0.0))
    eye = np.asarray(camera_position[0], np.float64)
    focal = np.asarray(camera_position[1], np.float64)
    up = np.asarray(camera_position[2], np.float64)

    fwd = focal - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])                     # world -> cam
    pc = (pts - eye) @ R.T
    vis = pc[:, 2] > 1e-6
    pc, cc = pc[vis], (cols[vis] if cols is not None and len(cols)
                       else np.full((vis.sum(), 3), 80, np.uint8))
    f = 0.9 * min(width, height)                         # ~30 deg fov
    u = (f * pc[:, 0] / pc[:, 2] + width / 2).astype(np.int64)
    v = (f * pc[:, 1] / pc[:, 2] + height / 2).astype(np.int64)
    inb = (u >= 0) & (u < width) & (v >= 0) & (v < height)
    u, v, z, cc = u[inb], v[inb], pc[inb, 2], cc[inb]
    order = np.argsort(-z)                               # far first
    img = np.full((height, width, 3), background, np.uint8)
    for dy in range(point_size):
        for dx in range(point_size):
            vv = np.clip(v[order] + dy, 0, height - 1)
            uu = np.clip(u[order] + dx, 0, width - 1)
            img[vv, uu] = cc[order]
    plt.imsave(out_path, img)
    return out_path


def render_recon_screenshots(recons_root: str, out_dir: str,
                             variants=("ACMMP_no_prior.ply",
                                       "acmmp_boost_1.ply"),
                             camera_position=None) -> list:
    """Batch screenshot renderer over an experiment output tree
    (visualise_results.py main loop: per scan folder, one PNG per method
    variant)."""
    written = []
    for scan in sorted(os.listdir(recons_root)):
        sdir = os.path.join(recons_root, scan)
        if not os.path.isdir(sdir):
            continue
        for ply_name in variants:
            ply = os.path.join(sdir, ply_name)
            if not os.path.exists(ply):
                continue
            vdir = os.path.join(out_dir, os.path.splitext(ply_name)[0])
            os.makedirs(vdir, exist_ok=True)
            out = os.path.join(vdir, f"{scan}.png")
            written.append(render_cloud_screenshot(
                ply, out, camera_position=camera_position))
    return written
