#!/usr/bin/env python3
"""Where the time of the port's plain fusion goes, on a GPU.

    python3 tools/torch_fusion_profile.py [--tree DIR] \
        [--views 9 --width 1600 --height 1184 --reps 3]

Fuses the views of chip_smoke.py phase 8's scene (the textured plane at
z = 5, f = 600 W / 320, 9 views, each view's depth and normal cast from
the plane with 0.3% seeded depth noise and 0.01 normal noise), every
view a reference with all others as sources, through
acmmp_tpu_torch.engine.fusion.fuse_views of the checkout DIR (default:
this one), so two checkouts can be compared in one call. Warms up once,
times `--reps` whole fusions (wall, synchronized), then traces one with
torch.profiler: the device's busy time by class of kernel (float64
elementwise, float32 elementwise, the sampler, other), its idle share,
and the host-to-device copies. Prints one JSON line last. Needs a CUDA
device unless `--device cpu` (a small smoke run); imports nothing of
JAX."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def _group(name: str) -> str:
    """A coarse class of a device kernel, by its name."""
    if "gather2d" in name or "sample" in name:
        return "sampler (csrc/sample.cu)"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy / memset"
    if "double" in name:
        return "float64 elementwise"
    if "elementwise" in name or "reduce" in name:
        return "float32 / int elementwise"
    return "other"


def _views(args):
    """(image, NumpyCamera, depth, camera-frame normal) per view."""
    from acmmp_tpu_torch.utils.synth import textured_plane_scene

    w, h = args.width, args.height
    images, cams, plane_z = textured_plane_scene(
        n_views=args.views, width=w, height=h, f=600.0 * w / 320.0,
        plane_z=5.0)
    rng = np.random.default_rng(0)
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    out = []
    for img, cam in zip(images, cams):
        ray = np.stack([(xs - cam.K[0, 2]) / cam.K[0, 0],
                        (ys - cam.K[1, 2]) / cam.K[1, 1],
                        np.ones_like(xs)], -1)          # camera frame, z 1
        d_world = ray @ cam.R                           # R^T ray
        centre = -cam.R.T @ cam.t
        depth = (plane_z - centre[2]) / d_world[..., 2]
        depth = depth * (1.0 + 0.003 * rng.normal(size=depth.shape))
        n = np.broadcast_to(cam.R @ np.array([0.0, 0.0, -1.0]), (h, w, 3))
        n = n + 0.01 * rng.normal(size=(h, w, 3))
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        rgb = np.stack([img] * 3, -1).astype(np.float32)
        out.append((rgb, cam, depth.astype(np.float32),
                    n.astype(np.float32)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--views", type=int, default=9)
    ap.add_argument("--width", type=int, default=1600)
    ap.add_argument("--height", type=int, default=1184)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("torch_fusion_profile: no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from torch.profiler import ProfilerActivity, profile

    from acmmp_tpu_torch.config import FusionParams
    from acmmp_tpu_torch.engine import fusion
    from acmmp_tpu_torch.io.dense_folder import Problem

    assert fusion.__file__.startswith(tree), fusion.__file__
    data = _views(args)
    n = len(data)
    problems = [Problem(ref_image_id=i,
                        src_image_ids=[j for j in range(n) if j != i])
                for i in range(n)]
    fp = FusionParams()

    def fuse():
        views = {i: fusion.FusionView(*v) for i, v in enumerate(data)}
        pts = fusion.fuse_views(views, problems, fp, device=args.device)[0]
        if cuda:
            torch.cuda.synchronize()
        return len(pts)

    points = fuse()                                     # warm-up, builds
    walls = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        assert fuse() == points
        walls.append(time.perf_counter() - t0)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fuse()
        traced = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                            getattr(e, "self_cuda_time_total", 0)) / 1e6
    busy = sum(dev(e) for e in events)
    groups = {}
    for e in events:
        g = _group(e.key)
        s, k = groups.get(g, (0.0, 0))
        groups[g] = (s + dev(e), k + e.count)
    htod = sum(e.count for e in events if "HtoD" in e.key)
    card = torch.cuda.get_device_name(0) if cuda else "cpu"
    print(f"{card}; tree {tree}; {n} views {args.width}x{args.height}, "
          f"{points} points")
    print(f"fusion wall {min(walls):.3f}-{max(walls):.3f} s over "
          f"{args.reps}; traced {traced:.3f} s, device busy {busy:.3f} s "
          f"over {sum(e.count for e in events)} device ops, idle share "
          f"{max(0.0, 1 - busy / traced):.3f}; host-to-device copies "
          f"{htod}")
    for g, (s, k) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  group {g:28s} {s:8.4f} s  x{k:<7d} "
              f"{s / max(busy, 1e-12):.3f} of busy")
    for e in sorted(events, key=dev, reverse=True)[:args.top]:
        print(f"  {dev(e):8.4f} s  x{e.count:<6d} {e.key[:110]}")
    print(json.dumps({
        "tree": tree, "device": card, "views": n,
        "width": args.width, "height": args.height, "points": points,
        "wall_s": walls, "traced_s": traced, "busy_s": busy,
        "idle_share": max(0.0, 1 - busy / traced) if cuda else None,
        "device_ops": sum(e.count for e in events), "htod_copies": htod,
        "groups_s": {g: s for g, (s, _) in groups.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
