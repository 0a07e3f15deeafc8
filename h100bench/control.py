"""The check's readings on many seeds in one process: for each seed, a
cell's set-up, warm-up and `--units` units of its window, then the check
of the last of them (a run checks the unit it draws from the seed);
with `--control`, the control's numbers beside the program's (the
reference with its ZNCC moments in bfloat16, put in the program's
place); with `--fault`, the program broken underneath (faults.py). One
JSON line per seed.

    python3 h100bench/control.py --workload dtu_1600.geom_b4 \
        --seeds 11,12,13 [--control] [--fault unchanged] [--units 2]

Needs a CUDA device unless `--device cpu` (the tests, at tiny sizes)."""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from h100bench import faults, harness  # noqa: E402


def readings(cfg, mix, seed, units, device, control=False):
    """(program's numbers, control's numbers or None, info) of one
    seed."""
    import torch

    driver = importlib.import_module(f"h100bench.drivers.{mix['driver']}")
    drv = driver.Driver(cfg, mix, seed, device, harness.Spans())
    drv.warmup()
    drv.pick = units - 1
    for _ in range(units):
        drv.step()
    drv.release()
    numbers, info = drv.check()
    ctl = drv.control() if control else None
    del drv
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return numbers, ctl, info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--units", type=int, default=2)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.cache_dirs()
    _, cfg, mix = harness.cell(harness.spec(), args.workload)
    undo = faults.plant(args.fault) if args.fault else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            numbers, ctl, info = readings(cfg, mix, seed, args.units,
                                          args.device, args.control)
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "fault": args.fault, "program": numbers,
                               "control": ctl, "info": info,
                               "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    finally:
        if undo is not None:
            undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
