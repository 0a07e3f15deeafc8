#!/usr/bin/env python3
"""Where the time of one acmmp_tpu_torch solve goes, on a GPU.

    python3 tools/torch_solve_profile.py [--width 1600 --height 1184 --src 8]

Builds the bench scene (textured plane, f = 600 * width / 320, z = 5),
warms up one photometric solve with the shipping PatchMatchParams(), then
traces one more with torch.profiler (CPU and CUDA activity). Prints the
solve's wall time, the summed device time of its kernels, the device's
idle share over the solve, the ZNCC kernel's share, and the kernels that
take the most device time. Needs a CUDA device; imports nothing of JAX."""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch


def _group(name: str) -> str:
    """A coarse class of a device kernel, by its name."""
    if "zncc" in name:
        return "zncc (csrc/zncc.cu)"
    if "gather" in name or "index" in name:
        return "gather / index"
    if "scan" in name:
        return "scan (cumsum)"
    if "Sort" in name or "sort" in name:
        return "sort"
    if "reduce_kernel" in name:
        return "reduction"
    if "Cat" in name or "copy" in name.lower():
        return "cat / copy"
    if "elementwise" in name and "<long" in name:
        return "int64 elementwise"
    if "elementwise" in name:
        return "other elementwise"
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1600)
    ap.add_argument("--height", type=int, default=1184)
    ap.add_argument("--src", type=int, default=8)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_solve_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from torch.profiler import ProfilerActivity, profile

    from acmmp_tpu_torch.config import PatchMatchParams
    from acmmp_tpu_torch.engine.inputs import build_solver_inputs
    from acmmp_tpu_torch.engine.patchmatch import Mode, run_patchmatch
    from acmmp_tpu_torch.ops import keys
    from acmmp_tpu_torch.utils.synth import textured_plane_scene

    params = PatchMatchParams()
    images, cams, _ = textured_plane_scene(
        n_views=args.src + 1, width=args.width, height=args.height,
        f=600.0 * args.width / 320.0, plane_z=5.0)
    inputs = build_solver_inputs(images[0], images[1:], cams[0], cams[1:],
                                 params, device="cuda")
    run_patchmatch(inputs, keys.key(1), params, Mode())      # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_patchmatch(inputs, keys.key(2), params, Mode())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (CPU ops also report their kernels' time)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                            getattr(e, "self_cuda_time_total", 0)) / 1e3
    busy = sum(dev(e) for e in events)
    zncc = sum(dev(e) for e in events if "zncc" in e.key)
    n_launch = sum(e.count for e in events)
    print(f"{torch.cuda.get_device_name(0)}; {args.width}x{args.height}, "
          f"{args.src} sources")
    print(f"solve wall {wall_ms:.1f} ms (traced); device busy {busy:.1f} ms "
          f"over {n_launch} device ops; idle share "
          f"{max(0.0, 1 - busy / wall_ms):.3f}; zncc {zncc:.1f} ms "
          f"({zncc / max(busy, 1e-9):.3f} of busy)")
    groups = {}
    for e in events:
        g = _group(e.key)
        ms, n = groups.get(g, (0.0, 0))
        groups[g] = (ms + dev(e), n + e.count)
    for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  group {g:28s} {ms:9.3f} ms  x{n:<6d} "
              f"{ms / max(busy, 1e-9):.3f} of busy")
    for e in sorted(events, key=dev, reverse=True)[:args.top]:
        print(f"  {dev(e):9.3f} ms  x{e.count:<5d} {e.key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
