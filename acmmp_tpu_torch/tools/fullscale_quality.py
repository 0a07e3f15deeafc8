"""Full-scale quality of the port: one real `run_pipeline` over a synthetic
scene with exact analytic ground truth, scored by the DTU protocol
(eval/dtu.py) — the port of the JAX package's
``tools/fullscale_quality.py``, with its flags, scene, SCALE and JSON keys.

Scene: the non-planar textured relief height-field
(utils/synth.textured_relief_scene) at 1280x960 with 6 views, f =
140 * W / 96, on a wide convergent rig (spread 1.2, ~27 degrees end to
end) so the mm-scale metrics measure matching quality, not triangulation
conditioning. The multi-scale planner gives 2 scales at this size (coarse
pass + JBU + fine pass), and fusion produces the cloud that is scored.
Ground truth is the analytic surface ray-cast over every view's frustum
(utils/synth.relief_gt_points).

Units: the scene lives at depth ~5; clouds are scaled by SCALE = 150
before scoring (depth 5 -> 750 "mm", ~0.31 mm per pixel at f = 1867, the
DTU class), so the standard acc/cmp@{0.5,2,5,10} mm cuts apply as-is.

    python -m acmmp_tpu_torch.tools.fullscale_quality [--width 1280
        --height 960] [--views 6] [--geom_iters 2] [--window W]
        [--min_cos C] [--out QUALITY_fullscale_torch.json] [--device cpu]

It runs on CUDA unless ``--device cpu`` (or ``--cpu``) is given. It
prints the card's name and power limit (on CUDA), then one JSON line:
the JAX tool's keys (``pipeline_wall_s`` is the host wall of
``run_pipeline``), plus ``device`` (the card line, or "cpu") and the
host walls of the scene, the ground truth and the evaluation; ``--out``
writes the same object to a file."""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from acmmp_tpu_torch import runtime
from acmmp_tpu_torch.config import PatchMatchParams, PipelineConfig
from acmmp_tpu_torch.eval.dtu import dtu_metrics
from acmmp_tpu_torch.io import read_ply
from acmmp_tpu_torch.pipeline.scheduler import run_pipeline
from acmmp_tpu_torch.tools.prop_ablate import card_line
from acmmp_tpu_torch.utils.synth import (relief_gt_points,
                                         textured_relief_scene,
                                         write_dense_folder)

SCALE = 150.0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m acmmp_tpu_torch.tools.fullscale_quality",
        description="DTU-protocol quality of one run_pipeline on the "
                    "relief scene.")
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=960)
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--geom_iters", type=int, default=2)
    ap.add_argument("--out", default="")
    ap.add_argument("--dense", default="", help="reuse/keep dense folder")
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    ap.add_argument("--device", default=runtime.DEFAULT_DEVICE)
    ap.add_argument("--window", type=float, default=None,
                    help="rand_depth_tile_window override (0 = exact "
                         "reference semantics; default = shipping value)")
    ap.add_argument("--min_cos", type=float, default=None,
                    help="rand_normal_min_cos override (0 = exact)")
    args = ap.parse_args(argv)
    dev = runtime.resolve_device("cpu" if args.cpu else args.device)
    device = card_line() if dev.type == "cuda" else "cpu"
    if dev.type == "cuda":
        print(device, flush=True)

    W, H, V = args.width, args.height, args.views
    t0 = time.monotonic()
    images, cams, _ = textured_relief_scene(
        n_views=V, width=W, height=H, f=140.0 * W / 96.0, spread=1.2,
        converge=True)
    dense = args.dense or tempfile.mkdtemp(prefix="acmmp_fullscale_")
    if not os.path.exists(os.path.join(dense, "pair.txt")):
        write_dense_folder(dense, images, cams)
    scene_s = time.monotonic() - t0
    print(f"scene rendered in {scene_s:.1f}s", flush=True)

    pm_kw = {}
    if args.window is not None:
        pm_kw["rand_depth_tile_window"] = args.window
    if args.min_cos is not None:
        pm_kw["rand_normal_min_cos"] = args.min_cos
    cfg = PipelineConfig(geom_iterations=args.geom_iters,
                         patchmatch=PatchMatchParams(**pm_kw))
    t0 = time.monotonic()
    ply = run_pipeline(dense, cfg, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.monotonic() - t0

    t0 = time.monotonic()
    gt_pts = relief_gt_points(cams, W, H)
    gt_s = time.monotonic() - t0
    t0 = time.monotonic()
    recon_pts, _, _ = read_ply(ply)
    metrics = dtu_metrics(np.asarray(recon_pts, np.float64) * SCALE,
                          gt_pts * SCALE, dst=0.2)
    eval_s = time.monotonic() - t0
    result = {
        "tool": "fullscale_quality",
        "shape": f"{W}x{H}", "views": V, "geom_iters": args.geom_iters,
        "rand_depth_tile_window": cfg.patchmatch.rand_depth_tile_window,
        "rand_normal_min_cos": cfg.patchmatch.rand_normal_min_cos,
        "pipeline_wall_s": round(wall, 2),
        "device": device,
        "scene_s": round(scene_s, 2), "gt_s": round(gt_s, 2),
        "eval_s": round(eval_s, 2), "points": int(len(recon_pts)),
        "gt_points": int(len(gt_pts)),
        "ply": ply,
        "metrics": {k: round(float(v), 4) for k, v in metrics.items()},
        "scale_to_mm": SCALE,
    }
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    return result


if __name__ == "__main__":
    main()
