"""The benchmark's scenes: a textured height field seen by a convergent
rig, made on the device from the run's seed.

A torch rewrite of the relief scene of the program's synthetic scenes
(a height field rendered by Newton steps along each ray, texture as a
sum of plane waves in world coordinates, so every view is
photo-consistent by construction), with what a benchmark needs beside
it: a rig on a sphere around the surface (the DTU and ETH3D rigs
converge), texture whose shortest wavelength is one patch at the
configuration's resolution, each view's sources chosen by the angle
between optical axes (as a `pair.txt` lists them), and the truth:
every view's depth and world normal.

Sizes come from the configuration's `scene` group; the seed draws the
texture, and the previous pass's errors (`previous_pass`). The same
seed gives the same scene bit for bit on one card."""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch


@dataclasses.dataclass
class View:
    """One camera as host arrays: K [3, 3], R [3, 3] (world to camera),
    t [3], and its depth range."""

    K: np.ndarray
    R: np.ndarray
    t: np.ndarray
    depth_min: float
    depth_max: float


@dataclasses.dataclass
class Scene:
    """A rendered scene on one device. images [N, H, W] float32 holding
    8-bit values; depth [N, H, W] (camera z); normal [N, H, W, 3] (world,
    facing the camera); pairs[i] the sources of view i, best first."""

    images: torch.Tensor
    depth: torch.Tensor
    normal: torch.Tensor
    views: List[View]
    pairs: List[List[int]]


def _look_at(eye: np.ndarray, target: np.ndarray):
    """World-to-camera rotation and translation of a camera at `eye`
    looking at `target`: +z forward, +x right, +y down."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)
    return R, -R @ eye


def rig(sc: dict) -> List[View]:
    """The cameras: a grid of `rig_rows` x `rig_cols` directions on a
    sphere of radius `distance` around (0, 0, distance), azimuth and
    elevation spread evenly over +-`azimuth_deg` and +-`elevation_deg`,
    the first `views` of them row by row."""
    W, H, f = sc["image_width"], sc["image_height"], sc["focal_px"]
    D = sc["distance"]
    target = np.array([0.0, 0.0, D])
    az = np.radians(np.linspace(-sc["azimuth_deg"], sc["azimuth_deg"],
                                sc["rig_cols"]))
    el = np.radians(np.linspace(-sc["elevation_deg"], sc["elevation_deg"],
                                sc["rig_rows"]))
    K = np.array([[f, 0.0, (W - 1) / 2.0], [0.0, f, (H - 1) / 2.0],
                  [0.0, 0.0, 1.0]])
    out = []
    for e in el:
        for a in az:
            d = np.array([math.sin(a) * math.cos(e), math.sin(e),
                          math.cos(a) * math.cos(e)])
            R, t = _look_at(target - D * d, target)
            out.append(View(K.astype(np.float32), R.astype(np.float32),
                            t.astype(np.float32),
                            float(sc["depth_min"]), float(sc["depth_max"])))
    if len(out) < sc["views"]:
        raise ValueError(f"a {sc['rig_rows']}x{sc['rig_cols']} rig holds "
                         f"fewer than {sc['views']} views")
    return out[:sc["views"]]


def pairs_by_angle(views: List[View], n_src: int) -> List[List[int]]:
    """Each view's `n_src` sources: the others by the angle between
    optical axes, smallest first (ties by index)."""
    axes = np.stack([v.R[2].astype(np.float64) for v in views])
    cos = np.clip(axes @ axes.T, -1.0, 1.0)
    out = []
    for i in range(len(views)):
        order = sorted((j for j in range(len(views)) if j != i),
                       key=lambda j: (-cos[i, j], j))
        out.append(order[:n_src])
    return out


def _surface(sc: dict, x, y):
    """Height z(x, y) of the relief and its two slopes."""
    a, z0 = sc["relief_amplitude"], sc["distance"]
    s = sc["relief_frequency"]
    u, v = s * x, s * y
    z = z0 + a * (torch.sin(1.1 * u) * torch.cos(0.9 * v)
                  + 0.5 * torch.sin(2.3 * u + 1.0))
    zx = a * s * (1.1 * torch.cos(1.1 * u) * torch.cos(0.9 * v)
                  + 1.15 * torch.cos(2.3 * u + 1.0))
    zy = -a * s * 0.9 * torch.sin(1.1 * u) * torch.sin(0.9 * v)
    return z, zx, zy


def _waves(sc: dict, gen: torch.Generator, device):
    """The texture's plane waves: wave numbers log-uniform from
    k_max / `texture_octave_span` to k_max, where k_max puts one
    wavelength on `texture_patch_px` pixels at the rig's distance;
    directions and phases uniform, amplitudes 0.3 to 1."""
    n = sc["texture_waves"]
    k_max = 2.0 * math.pi * sc["focal_px"] / (sc["texture_patch_px"]
                                              * sc["distance"])
    r = torch.rand(4, n, generator=gen, device=device, dtype=torch.float64)
    k = k_max * torch.exp(-math.log(sc["texture_octave_span"]) * r[0])
    theta = 2.0 * math.pi * r[1]
    kx, ky = k * torch.cos(theta), k * torch.sin(theta)
    return kx, ky, 2.0 * math.pi * r[2], 0.3 + 0.7 * r[3]


def _render(sc: dict, view: View, waves, device):
    """Ray-cast one view: (image, depth, world normal), [H, W] each and
    [H, W, 3] for the normal."""
    W, H = sc["image_width"], sc["image_height"]
    f64 = dict(device=device, dtype=torch.float64)
    K, R, t = (torch.as_tensor(a, **f64) for a in (view.K, view.R, view.t))
    C = -R.T @ t
    ys, xs = torch.meshgrid(torch.arange(H, **f64), torch.arange(W, **f64),
                            indexing="ij")
    d_cam = torch.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1],
                         torch.ones_like(xs)], -1)
    d = d_cam @ R                                   # world ray directions
    s = (sc["distance"] - C[2]) / d[..., 2]
    for _ in range(sc["newton_steps"]):
        p = C + s[..., None] * d
        z, zx, zy = _surface(sc, p[..., 0], p[..., 1])
        g = p[..., 2] - z
        s = s - g / (d[..., 2] - zx * d[..., 0] - zy * d[..., 1])
    p = C + s[..., None] * d
    _, zx, zy = _surface(sc, p[..., 0], p[..., 1])
    normal = torch.stack([zx, zy, -torch.ones_like(zx)], -1)
    normal = normal / normal.norm(dim=-1, keepdim=True)
    depth = ((p - C) @ R.T)[..., 2]
    kx, ky, phase, amp = waves
    val = torch.zeros_like(s, dtype=torch.float32)
    px, py = p[..., 0], p[..., 1]
    for i in range(kx.shape[0]):
        val += (amp[i] * torch.sin(kx[i] * px + ky[i] * py
                                   + phase[i])).float()
    sigma = float(torch.sqrt((amp ** 2).sum() / 2.0))
    img = torch.round(torch.clamp(130.0 + 100.0 * val / (2.0 * sigma),
                                  0.0, 255.0))
    return img, depth.float(), normal.float()


def make_scene(sc: dict, seed: int, device) -> Scene:
    """The configuration's scene (its `scene` group) on `device`, the
    texture drawn from `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    views = rig(sc)
    waves = _waves(sc, gen, device)
    H, W, N = sc["image_height"], sc["image_width"], sc["views"]
    images = torch.empty((N, H, W), device=device)
    depth = torch.empty((N, H, W), device=device)
    normal = torch.empty((N, H, W, 3), device=device)
    for i, v in enumerate(views):
        images[i], depth[i], normal[i] = _render(sc, v, waves, device)
    return Scene(images, depth, normal, views,
                 pairs_by_angle(views, sc["sources_per_view"]))


def previous_pass(scene: Scene, pp: dict, seed: int):
    """Depth and normal maps standing in for a previous pass's output,
    from the truth: depth times (1 + `depth_noise` N(0, 1)), a share
    `outlier_share` of pixels replaced by a depth uniform in the view's
    range, normals tilted by `normal_noise` N(0, 1) per component and
    turned to face the camera. Drawn on the device from `seed`."""
    dev = scene.depth.device
    gen = torch.Generator(device=dev)
    gen.manual_seed((int(seed) * 2 + 1) & 0xFFFFFFFFFFFFFFFF)
    shape = scene.depth.shape
    dmin = torch.tensor([v.depth_min for v in scene.views],
                        device=dev).view(-1, 1, 1)
    dmax = torch.tensor([v.depth_max for v in scene.views],
                        device=dev).view(-1, 1, 1)
    noise = torch.randn(shape, generator=gen, device=dev)
    depth = scene.depth * (1.0 + pp["depth_noise"] * noise)
    out = torch.rand(shape, generator=gen, device=dev) < pp["outlier_share"]
    uni = dmin + (dmax - dmin) * torch.rand(shape, generator=gen, device=dev)
    depth = torch.where(out, uni, depth)
    n = scene.normal + pp["normal_noise"] * torch.randn(
        scene.normal.shape, generator=gen, device=dev)
    n = n / n.norm(dim=-1, keepdim=True)
    # face the camera: the world normal's dot with the optical axis < 0
    axes = torch.tensor(np.stack([v.R[2] for v in scene.views]),
                        device=dev).view(-1, 1, 1, 3)
    n = torch.where(((n * axes).sum(-1, keepdim=True) > 0), -n, n)
    return depth, n
