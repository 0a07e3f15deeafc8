"""The benchmark's machinery, the same for every cell: the spec and its
files, the measured window, the traced stretch, the metric readers, the
result line.

A cell is an entry of `workloads` in BENCHMARK.json. Its configuration
(`configs/<name>.json`) holds the deployment's sizes, its traffic mix
(`mixes/<name>.json`) names the driver module (`drivers/<driver>.py`)
that stages and drives the program, and every metric is
`metrics/<name>.json`, which names its reader (`metrics/<reader>.py`).
So a new configuration, mix or metric is new files and an entry in
BENCHMARK.json, and no file here changes."""

from __future__ import annotations

import bisect
import contextlib
import importlib
import json
import os
import pathlib
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that may not be loaded in a measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "acmmp_tpu")


def load_json(rel: str) -> dict:
    with open(ROOT / rel) as f:
        return json.load(f)


def spec() -> dict:
    return load_json("BENCHMARK.json")


def cell(sp: dict, name: str):
    """(workload entry, configuration, mix) of the cell `name`."""
    wl = {w["name"]: w for w in sp["workloads"]}.get(name)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = {c["name"]: c for c in sp["configs"]}[wl["config"]]
    cfg = load_json(entry["file"])
    mix = load_json(f"{HERE.name}/mixes/{wl['traffic']}.json")
    return wl, cfg, mix


def cell_metrics(sp: dict, wl_name: str, kind: str) -> List[dict]:
    """The `kind` ("end_to_end" or "per_layer") metrics the cell
    reports: those that list it, and those without a list whose moved
    metric the cell reports."""
    e2e = {m["name"] for m in sp["end_to_end"]
           if "workloads" not in m or wl_name in m["workloads"]}
    out = []
    for m in sp[kind]:
        if "workloads" in m:
            if wl_name in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Spans:
    """Host spans, recorded while `on` (traced runs only)."""

    def __init__(self):
        self.on = False
        self.spans: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name].append(time.perf_counter() - t0)

    def wrap(self, name: str, fn):
        """`fn` with each call recorded as span `name`."""
        def wrapped(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)
        return wrapped


class Window:
    """What the measured window saw: units counted, the time from its
    start to the last unit completed in it, and set-up."""

    def __init__(self, setup_s: float):
        self.setup_s = setup_s
        self.units = 0
        self.attempted = 0
        self.failed = 0
        self.elapsed_s = 0.0
        self.unit_times: List[float] = []


class Trace:
    """The traced stretch: device kernels and host ops from the
    profiler, its host-clock length, the units it covered, the work
    tally of those units and the host spans."""

    def __init__(self, prof, window_s: float, units: int, tally: dict,
                 spans: Spans, peaks: dict):
        # tally: {kernel: [(operations, bytes)] per launch} of the
        # stretch's units
        from torch.autograd import DeviceType

        self.window_s = window_s
        self.units = units
        self.tally = tally
        self.spans = spans.spans
        self.peaks = peaks
        self.kernels = []
        self.host_ops = []
        for e in prof.events():
            tr = e.time_range
            item = (e.name, tr.start * 1e-6, tr.end * 1e-6)
            if e.device_type == DeviceType.CUDA:
                self.kernels.append(item)
            elif e.device_type == DeviceType.CPU:
                self.host_ops.append(item)
        self.kernels.sort(key=lambda k: k[1])
        self.busy_intervals = _union([(s, e) for _, s, e in self.kernels])
        self.busy_s = sum(e - s for s, e in self.busy_intervals)

    def kernel_time(self, include=(), exclude=()) -> float:
        """Summed device seconds of kernels whose name holds any of
        `include` (all when empty) and none of `exclude`."""
        return sum(e - s for n, s, e in self.kernels
                   if (not include or any(p in n for p in include))
                   and not any(p in n for p in exclude))

    def kernel_count(self, include=(), exclude=()) -> int:
        return sum(1 for n, _, _ in self.kernels
                   if (not include or any(p in n for p in include))
                   and not any(p in n for p in exclude))

    def breakdown(self) -> dict:
        by_name = defaultdict(float)
        for n, s, e in self.kernels:
            by_name[n[:160]] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = defaultdict(float)
        counts = defaultdict(int)
        iv = self.busy_intervals
        host = sorted(self.host_ops, key=lambda h: h[1])
        starts = [h[1] for h in host]
        for (_, e0), (s1, _) in zip(iv, iv[1:]):
            # the host op last started before the gap's middle: running
            # through it, or the op the host had finished last
            mid = 0.5 * (e0 + s1)
            i = bisect.bisect_right(starts, mid) - 1
            if i < 0:
                label = "before the first host op"
            else:
                n, _, e = host[i]
                label = n[:120] if e >= mid else f"after {n[:120]}"
            gaps[label] += s1 - e0
            counts[label] += 1
        top = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[f"{n} ({counts[n]} gaps)", v]
                              for n, v in top]}


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def peaks_of(kind: str) -> dict:
    """The published peaks of the card named `kind` (peaks.json, by the
    first key the name contains)."""
    table = load_json(f"{HERE.name}/peaks.json")
    for key, val in table.items():
        if key in kind:
            return val
    raise SystemExit(f"no peaks for {kind!r} in peaks.json")


def read_metric(m: dict, window: Window, trace: Optional[Trace]):
    """The value of metric `m` by its reader (metrics/<reader>.py), or
    None when the reader finds nothing to read."""
    mspec = load_json(f"{HERE.name}/metrics/{m['name']}.json")
    reader = importlib.import_module(
        f"{HERE.name}.metrics.{mspec['reader']}")
    return reader.read(mspec, window, trace)


def launches() -> dict:
    """The program's own kernel-launch counters, a check on each cell's
    schedule (13 ZNCC launches a solve, 9 geom a geometric one)."""
    from acmmp_tpu_torch.ops import cuda_geom, cuda_ncc

    return {"zncc": cuda_ncc.total_launches(),
            "geom": cuda_geom.total_launches()}


def device_info(count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(count))}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own kernels build into build/torch_kernels), and no
    library loading JAX by itself."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
