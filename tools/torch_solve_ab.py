#!/usr/bin/env python3
"""Time the photometric main path (chip_smoke.py phase 5: one 1600x1184
solve with 8 sources, PatchMatchParams(), Mode()) of two or more checkouts
of acmmp_tpu_torch on one GPU, alternating, in one run; with --pipeline,
phase 8 instead (run_pipeline with PipelineConfig() on a 9-view 1600x1184
dense folder of the textured plane at texture scale 24).

    python3 tools/torch_solve_ab.py TREE_A TREE_B [--rounds 3] [--solves 5]
    python3 tools/torch_solve_ab.py TREE_A TREE_B --pipeline [--rounds 2]

Each TREE is the root of a checkout (the directory that holds
acmmp_tpu_torch/). Round r runs every tree once, in the given order when r
is even and reversed when it is odd (A B B A A B ...), each in a fresh
process that imports the package from that tree only, builds its kernels,
makes phase 5's scene, runs one warm-up solve and then `--solves` timed
solves (CUDA events around each; the host clock beside them). Prints one
line per process and, at the end, each tree's device-ms per solve over
all rounds (min, median, max). A --pipeline process writes the dense
folder into a fresh temporary directory, runs the pipeline once and
reports its wall (host clock) and its stage walls; the summary is over
the walls. Needs a CUDA device."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def worker(tree: str, n_solves: int) -> dict:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import acmmp_tpu_torch
    from acmmp_tpu_torch.config import PatchMatchParams
    from acmmp_tpu_torch.engine.inputs import build_solver_inputs
    from acmmp_tpu_torch.engine.patchmatch import Mode, run_patchmatch
    from acmmp_tpu_torch.kernels import _build
    from acmmp_tpu_torch.ops import keys
    from acmmp_tpu_torch.utils.synth import textured_plane_scene

    assert os.path.abspath(acmmp_tpu_torch.__file__).startswith(tree)
    _build.build(_build.all_kernels())
    params = PatchMatchParams()
    images, cams, _ = textured_plane_scene(n_views=9, width=1600,
                                           height=1184, f=3000.0,
                                           plane_z=5.0)
    inputs = build_solver_inputs(images[0], images[1:], cams[0], cams[1:],
                                 params, device=torch.device("cuda"))
    run_patchmatch(inputs, keys.key(1), params, Mode())        # warm-up
    torch.cuda.synchronize()
    dev_ms, host_ms = [], []
    for i in range(n_solves):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        a.record()
        run_patchmatch(inputs, keys.key(2 + i), params, Mode())
        b.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(a.elapsed_time(b))
    return {"tree": tree, "dev_ms": dev_ms, "host_ms": host_ms}


def pipeline_worker(tree: str) -> dict:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import logging
    import shutil
    import tempfile

    import acmmp_tpu_torch
    from acmmp_tpu_torch.config import PipelineConfig
    from acmmp_tpu_torch.kernels import _build
    from acmmp_tpu_torch.pipeline.scheduler import run_pipeline
    from acmmp_tpu_torch.utils.synth import (textured_plane_scene,
                                             write_dense_folder)

    assert os.path.abspath(acmmp_tpu_torch.__file__).startswith(tree)
    _build.build(_build.all_kernels())
    stages = []

    class Stages(logging.Handler):
        def emit(self, record):
            if hasattr(record, "stage"):
                stages.append((record.stage, round(record.seconds, 2)))

    logging.getLogger("acmmp_tpu_torch").addHandler(Stages())
    images, cams, _ = textured_plane_scene(n_views=9, width=1600,
                                           height=1184, f=3000.0,
                                           plane_z=5.0, texture_scale=24.0)
    work = tempfile.mkdtemp(prefix="torch_solve_ab_")
    try:
        dense = write_dense_folder(os.path.join(work, "dense"), images, cams)
        t0 = time.perf_counter()
        run_pipeline(dense, PipelineConfig(), device="cuda")
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"tree": tree, "wall_s": wall, "stages": stages}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--solves", type=int, default=5)
    ap.add_argument("--pipeline", action="store_true",
                    help="time phase 8's pipeline run, not phase 5's solve")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        res = (pipeline_worker(args.trees[0]) if args.pipeline
               else worker(args.trees[0], args.solves))
        print(json.dumps(res), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    results = {os.path.abspath(t): [] for t in args.trees}
    for r in range(args.rounds):
        order = args.trees if r % 2 == 0 else args.trees[::-1]
        for tree in order:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), tree,
                 "--solves", str(args.solves), "--worker"]
                + (["--pipeline"] if args.pipeline else []),
                capture_output=True, text=True, timeout=900, check=True)
            res = json.loads(out.stdout.strip().splitlines()[-1])
            if args.pipeline:
                results[res["tree"]].append(res["wall_s"])
                print(f"round {r} {tree}: pipeline wall "
                      f"{res['wall_s']:.2f} s, stages {res['stages']}",
                      flush=True)
                continue
            results[res["tree"]].extend(res["dev_ms"])
            print(f"round {r} {tree}: device ms "
                  f"{[round(x, 1) for x in res['dev_ms']]}, host ms "
                  f"{[round(x, 1) for x in res['host_ms']]}", flush=True)
    what = "pipeline s" if args.pipeline else "device ms per solve"
    for tree, ms in results.items():
        print(f"{tree}: {what} min {min(ms):.2f}, median "
              f"{statistics.median(ms):.2f}, max {max(ms):.2f} over "
              f"{len(ms)} runs", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
