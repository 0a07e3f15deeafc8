"""Quality + speed A/B of the random-search laws on the port — the port of
the JAX package's ``tools/rand_window_ab.py``, with its flags and record
keys (less its ``--geom``, which that tool accepts and never reads).

Runs the photometric solve from random init on the synthetic textured
plane (or, with ``--scene relief``, the non-planar relief scored against
its analytic ground-truth depth) across several seeds, for each
``rand_depth_tile_window`` fraction (0 = exact reference semantics)
crossed with each ``rand_normal_min_cos`` (0 = the exact normal law),
and reports per-variant depth accuracy and solve time. The windowed
depth marginal is trapezoidal (edge ramps of width f * range,
DEVIATIONS.md #18), so true depths near the range ends are the
adversarial case: run with ``--plane_z`` near depth_max (the range is
[2, 10]) as well as the mid-range default.

    python -m acmmp_tpu_torch.tools.rand_window_ab [--height 240
        --width 320 --views 4] [--windows 0,0.25,0.125] [--min_cos 0,0.25]
        [--seeds 4] [--plane_z 5.0] [--scene plane|relief] [--json out]
        [--device cpu]

It runs on CUDA unless ``--device cpu`` (or ``--cpu``) is given. On CUDA
a solve's time is taken with CUDA events (ms_per_solve: the mean over the
seeds after the first), and the card's name and power limit are printed
first and stored in every record's ``device``; on the CPU the times are
the host clock's and ``device`` is "cpu"."""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from acmmp_tpu_torch import runtime
from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.engine.inputs import build_solver_inputs
from acmmp_tpu_torch.engine.patchmatch import Mode, run_patchmatch
from acmmp_tpu_torch.ops import keys
from acmmp_tpu_torch.tools.prop_ablate import card_line
from acmmp_tpu_torch.utils.synth import (textured_plane_scene,
                                         textured_relief_scene)


def timed_solve(inputs, key, params, dev):
    """One photometric solve and its time in ms (CUDA events on the card,
    the host clock on the CPU)."""
    if dev.type == "cuda":
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = run_patchmatch(inputs, key, params, Mode())
        b.record()
        torch.cuda.synchronize(dev)
        return out, a.elapsed_time(b)
    t0 = time.perf_counter()
    out = run_patchmatch(inputs, key, params, Mode())
    return out, (time.perf_counter() - t0) * 1e3


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m acmmp_tpu_torch.tools.rand_window_ab",
        description="Quality and speed of the random-search laws.")
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--windows", default="0,0.25,0.125")
    ap.add_argument("--plane_z", type=float, default=5.0,
                    help="true plane depth; near 10 (range max) probes the "
                         "trapezoidal-marginal edge suppression")
    ap.add_argument("--min_cos", default="",
                    help="comma list of rand_normal_min_cos values to "
                         "cross with each window (e.g. 0,0.25); empty = "
                         "reference law only")
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    ap.add_argument("--device", default=runtime.DEFAULT_DEVICE)
    ap.add_argument("--scene", default="plane", choices=["plane", "relief"])
    ap.add_argument("--spread", type=float, default=1.2,
                    help="relief rig camera spread; >= 1 with a "
                         "convergent rig conditions triangulation like "
                         "DTU")
    ap.add_argument("--parallel_rig", action="store_true",
                    help="use the weak rig (spread=0.22, non-convergent)")
    ap.add_argument("--json", default="",
                    help="append one JSON line per variant to this file")
    args = ap.parse_args(argv)
    dev = runtime.resolve_device("cpu" if args.cpu else args.device)
    device = card_line() if dev.type == "cuda" else "cpu"
    if dev.type == "cuda":
        print(device, flush=True)

    if args.scene == "plane":
        images, cams, plane_z = textured_plane_scene(
            n_views=args.views + 1, width=args.width, height=args.height,
            f=600.0 * args.width / 320.0, plane_z=args.plane_z)
        gt = np.full((args.height, args.width), plane_z, np.float32)
    else:
        spread = 0.22 if args.parallel_rig else args.spread
        images, cams, gt = textured_relief_scene(
            n_views=args.views + 1, width=args.width, height=args.height,
            f=140.0 * args.width / 96.0, spread=spread,
            converge=not args.parallel_rig)

    H, W = args.height, args.width
    interior = np.s_[8:H - 8, 8:W - 8]

    coss = [float(t) for t in args.min_cos.split(",") if t] or [0.0]
    records = []
    for wtxt in args.windows.split(","):
        for mc in coss:
            w = float(wtxt)
            params = PatchMatchParams(rand_depth_tile_window=w,
                                      rand_normal_min_cos=mc)
            inputs = build_solver_inputs(images[0], images[1:], cams[0],
                                         cams[1:], params, device=dev)
            errs, inliers, times = [], [], []
            for s in range(args.seeds):
                out, ms = timed_solve(inputs, keys.key(100 + s), params,
                                      dev)
                times.append(ms)
                d = out.depth.cpu().numpy()[:H, :W][interior]
                e = np.abs(d - gt[interior])
                errs.append(float(np.median(e)))
                inliers.append(float((e < 0.1).mean()))
            rec = {
                "scene": args.scene,
                "rig": (None if args.scene == "plane" else
                        "parallel0.22" if args.parallel_rig else
                        f"converge{args.spread}"),
                "h": H, "w": W, "views": args.views,
                "plane_z": args.plane_z if args.scene == "plane" else None,
                "window": w, "min_cos": mc,
                "median_err": round(float(np.mean(errs)), 5),
                "median_err_std": round(float(np.std(errs)), 5),
                "inliers_0.1": round(float(np.mean(inliers)), 4),
                "inliers_std": round(float(np.std(inliers)), 4),
                "ms_per_solve": round(float(np.mean(times[1:] or times)), 3),
                "device": device,
            }
            records.append(rec)
            print(f"window={w:6.3f} min_cos={mc:5.2f}: median_err "
                  f"{rec['median_err']:.4f} +- {rec['median_err_std']:.4f}   "
                  f"inliers@0.1 {rec['inliers_0.1']:.3f} +- "
                  f"{rec['inliers_std']:.3f}  "
                  f" {rec['ms_per_solve']:8.3f} ms/solve", flush=True)
            if args.json:
                with open(args.json, "a") as fh:
                    fh.write(json.dumps(rec) + "\n")
    return records


if __name__ == "__main__":
    main()
