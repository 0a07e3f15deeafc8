"""Run one benchmark cell once and print its result line.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (an entry of `workloads` in BENCHMARK.json) names a
configuration and a traffic mix; the mix names the driver that stages
and drives the program (the PyTorch/CUDA port, `acmmp_tpu_torch`). Set-up
makes the scene from the seed and warms every shape the cell uses; the
window then drives the program for `--seconds` and counts the units it
completes. With `--trace 1` the profiler records a short steady stretch
of the window and the cell's per-layer metrics are read from it. Once the
window has closed, the peak device memory is read, the program's state
freed and a sample of the window's output, drawn from the seed, held to
the plain reference (`reference/`). The last line of standard output is
one JSON object: `correct`, `attempted`, `failed`, `metrics`, `device`,
with `--trace 1` `breakdown`, and last `checks`, each number compared
beside its limit; the same numbers end standard error.

Exits non-zero, printing no result, without enough CUDA devices, or when
JAX, Flax or the JAX package is loaded once the window has closed."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from h100bench import harness  # noqa: E402

# the card a run measures (tests rehearse the harness on the CPU)
DEVICE = "cuda:0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be non-negative")
    harness.cache_dirs()
    sp = harness.spec()
    wl, cfg, mix = harness.cell(sp, args.workload)

    import torch

    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < wl["chips"]):
        print(f"run.py: {args.workload} needs {wl['chips']} CUDA "
              f"device(s); {torch.cuda.device_count()} available",
              file=sys.stderr)
        return 2
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    driver = importlib.import_module(f"h100bench.drivers.{mix['driver']}")
    spans = harness.Spans()
    drv = driver.Driver(cfg, mix, args.seed, DEVICE, spans)
    drv.warmup()
    torch.cuda.synchronize()
    window = harness.Window(time.perf_counter() - T_START)

    trace = None
    trace_at = (mix["trace_first_unit"] if args.trace else -1)
    traced_steps, traced_units, prof = 0, 0, None
    t0 = time.perf_counter()
    step = 0
    while True:
        if step == trace_at:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
            spans.on = True
            t_tr = time.perf_counter()
        times = drv.step()          # completion times of its units
        step += 1
        window.attempted += len(times)
        if prof is not None and spans.on:
            traced_steps += 1
            traced_units += len(times)
            if traced_steps == mix["trace_units"]:
                torch.cuda.synchronize()
                t_tr = time.perf_counter() - t_tr
                spans.on = False
                prof.stop()
        for t in times:
            if t - t0 <= args.seconds:
                window.units += 1
                window.elapsed_s = t - t0
                window.unit_times.append(t - t0)
        if times[-1] - t0 > args.seconds:
            break
    if prof is not None and spans.on:       # the window ended first
        torch.cuda.synchronize()
        t_tr = time.perf_counter() - t_tr
        spans.on = False
        prof.stop()
    found = harness.forbidden_modules()
    if found:
        print(f"run.py: loaded in the measured process: {found}",
              file=sys.stderr)
        return 3
    device = harness.device_info(wl["chips"])
    if prof is not None:
        t_read = time.perf_counter()
        trace = harness.Trace(prof, t_tr, traced_units,
                              drv.tally(traced_steps), spans,
                              harness.peaks_of(device["kind"]))
        print(f"trace: {traced_units} units, {len(trace.kernels)} device ops, "
              f"{len(trace.host_ops)} host ops, read in "
              f"{time.perf_counter() - t_read:.1f} s", file=sys.stderr)
        device["busy_s"] = trace.busy_s
        device["window_s"] = trace.window_s

    metrics = {}
    kind = "per_layer" if args.trace else "end_to_end"
    for m in harness.cell_metrics(sp, wl["name"], kind):
        v = harness.read_metric(m, window, trace)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    drv.release()
    numbers, info = drv.check()
    limits = mix["limits"]
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    if window.units == 0:
        correct = False
        print("run.py: the window completed no unit", file=sys.stderr)
    gaps = [b - a for a, b in zip(window.unit_times, window.unit_times[1:])]
    print(f"window: {window.units} {drv.counted} in {window.elapsed_s} s; "
          f"first at {window.unit_times[:1]}, longest gap "
          f"{max(gaps, default=0.0)} s", file=sys.stderr)
    print(f"launches (set-up, window and tally): {harness.launches()}",
          file=sys.stderr)
    print(f"check: {json.dumps(info)}", file=sys.stderr)
    result = {"correct": correct, "attempted": window.attempted,
              "failed": window.failed, "metrics": metrics, "device": device}
    if trace is not None:
        result["breakdown"] = trace.breakdown()
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
