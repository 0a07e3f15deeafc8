#!/usr/bin/env python3
"""Time the photometric main path (chip_smoke.py phase 5: one 1600x1184
solve with 8 sources, PatchMatchParams(), Mode()) of two or more checkouts
of acmmp_tpu_torch on one GPU, alternating, in one run.

    python3 tools/torch_solve_ab.py TREE_A TREE_B [--rounds 3] [--solves 5]

Each TREE is the root of a checkout (the directory that holds
acmmp_tpu_torch/). Round r runs every tree once, in the given order when r
is even and reversed when it is odd (A B B A A B ...), each in a fresh
process that imports the package from that tree only, builds its kernels,
makes phase 5's scene, runs one warm-up solve and then `--solves` timed
solves (CUDA events around each; the host clock beside them). Prints one
line per process and, at the end, each tree's device-ms per solve over
all rounds (min, median, max). Needs a CUDA device."""

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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--solves", type=int, default=5)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.trees[0], args.solves)), flush=True)
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
                 "--solves", str(args.solves), "--worker"],
                capture_output=True, text=True, timeout=600, check=True)
            res = json.loads(out.stdout.strip().splitlines()[-1])
            results[res["tree"]].extend(res["dev_ms"])
            print(f"round {r} {tree}: device ms "
                  f"{[round(x, 1) for x in res['dev_ms']]}, host ms "
                  f"{[round(x, 1) for x in res['host_ms']]}", flush=True)
    for tree, ms in results.items():
        print(f"{tree}: device ms per solve min {min(ms):.1f}, median "
              f"{statistics.median(ms):.1f}, max {max(ms):.1f} over "
              f"{len(ms)} solves", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
