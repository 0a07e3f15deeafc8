#!/usr/bin/env python3
"""Whether the chain's scene (chip_smoke.py phase 7) lets the cost tell a
right depth from a wrong one, measured with the port.

    python3 tools/torch_chain_quality.py [--device cuda|cpu]
        [--width 800 --height 592 --f 1500] [--views 9]
        [--texture-scale 1]

On textured_plane_scene (a plane at z = 5, 9 views; the default texture,
or its frequencies times --texture-scale, as phase 7 renders it) it
solves view 0 photometrically at the coarse scale, once under the
shipping windowed random-depth law and once under the exact full-range
law (rand_depth_tile_window = 0), and prints for each the median interior
|depth - z|, the interior share under 0.5, and the median final cost of
the interior pixels off by more than 0.5 and of the rest: when the two
costs are alike, the cost cannot tell a wrong depth from a right one.
Then it upsamples the windowed solve's depth and normal with JBU to twice
the size (f doubled), as the chain does, initialises a hierarchy solve
there, and prints the share of pixels whose init cost exceeds the
hierarchy gate's margin. Costs are non-negative, so the gate (cost <
pre_cost - margin) can open only at those pixels.

Runs on the card unless given --device cpu (then use a small size: the
plain versions are slow). Imports nothing of JAX."""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys

import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=592)
    ap.add_argument("--f", type=float, default=1500.0)
    ap.add_argument("--views", type=int, default=9)
    ap.add_argument("--texture-scale", type=float, default=1.0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    from acmmp_tpu_torch.config import PatchMatchParams, PipelineConfig
    from acmmp_tpu_torch.engine.inputs import build_solver_inputs
    from acmmp_tpu_torch.engine.patchmatch import (Mode, init_state,
                                                   one_view, run_patchmatch)
    from acmmp_tpu_torch.ops import keys
    from acmmp_tpu_torch.ops.jbu import jbu_depth, jbu_normal_cost
    from acmmp_tpu_torch.utils.synth import textured_plane_scene

    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip(), flush=True)
    w, h = args.width, args.height
    coarse = textured_plane_scene(n_views=args.views, width=w, height=h,
                                  f=args.f, plane_z=5.0,
                                  texture_scale=args.texture_scale)
    fine = textured_plane_scene(n_views=args.views, width=2 * w,
                                height=2 * h, f=2 * args.f, plane_z=5.0,
                                texture_scale=args.texture_scale)
    # phase 7's key of view 0's first coarse solve (scheduler.py:347-348)
    key = keys.fold_in(keys.key(PipelineConfig().seed), 0)

    def inputs(scene, params, **maps):
        images, cams, _ = scene
        return build_solver_inputs(images[0], images[1:], cams[0], cams[1:],
                                   params, device=dev, **maps)

    def interior(a, width, height):
        return a[int(0.2 * height):int(0.8 * height),
                 int(0.19 * width):int(0.81 * width)]

    shipped = PatchMatchParams()
    outs = {}
    for name, params in (
            ("windowed law", shipped),
            ("exact law", dataclasses.replace(shipped,
                                              rand_depth_tile_window=0.0))):
        out = run_patchmatch(inputs(coarse, params), key, params, Mode())
        outs[name] = out
        err = interior(out.depth[:h, :w], w, h) - coarse[2]
        err = err.abs().float().cpu()
        cost = interior(out.cost[:h, :w], w, h).float().cpu()
        off = err > 0.5
        med = lambda t: (f"{t.median().item():.5f}" if t.numel()  # noqa: E731
                         else "none")
        print(f"{w}x{h} view 0 photometric, {name}: median interior "
              f"|depth - z| {err.median().item():.5f}, share < 0.5 "
              f"{1.0 - off.float().mean().item():.4f}; median cost off by "
              f"> 0.5 {med(cost[off])}, of the rest {med(cost[~off])}",
              flush=True)

    out = outs["windowed law"]
    gray = torch.as_tensor(fine[0][0], device=dev)
    up_d = jbu_depth(gray, out.depth[:h, :w].contiguous(), shipped)
    up_n, _ = jbu_normal_cost(gray, out.normal_world[:h, :w].contiguous(),
                              out.cost[:h, :w].contiguous(), shipped)
    fin = inputs(fine, shipped, init_depth=up_d.cpu().numpy(),
                 init_normal_world=up_n.cpu().numpy())
    state = one_view(init_state, fin, key, shipped, Mode(hierarchy=True))
    pre = state.pre_costs[:2 * h, :2 * w].float().cpu()
    margin = shipped.hierarchy_accept_margin
    share = (pre > margin).float().mean().item()
    share_in = (interior(pre, 2 * w, 2 * h) > margin).float().mean().item()
    print(f"{2 * w}x{2 * h} hierarchy init from the JBU'd windowed solve: "
          f"share of pixels with init cost > {margin} (where the gate can "
          f"open) {share:.4f}, interior {share_in:.4f}; median init cost "
          f"{pre.median().item():.5f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
