"""Lane probes on the GPU — the port of the JAX package's
``tools/mosaic_probe.py``, which asked whether Mosaic lowers the
operations the packed-gather ZNCC kernel needed: an int32 lane gather
along each axis of an (8, 128) tile, a per-lane variable right shift and a
byte unpack. Here each runs through its kernel in csrc/probes.cu
(ops/probes.py holds the plain versions).

    python -m acmmp_tpu_torch.tools.mosaic_probe [--device cuda]

It prints one ``name: OK [first 4 values]`` or ``name: FAIL <error>``
line per probe, then whether the lane gather and the shift equal numpy
("taa_i32 exact:", "dyn_shift exact:"), and exits non-zero if a probe
failed or differed. It runs on CUDA unless ``--device cpu`` is given."""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from acmmp_tpu_torch import runtime
from acmmp_tpu_torch.ops import probes

H, W = probes.ROWS, probes.LANES


def probe_inputs(seed: int = 0):
    """The probes' numpy inputs (mosaic_probe.py:30-32, from a seed):
    nonnegative int32 words, lane indices and byte shifts (0, 8, 16,
    24), each [8, 128]."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 31, (H, W)).astype(np.int32)
    idx = rng.integers(0, W, (H, W)).astype(np.int32)
    sh = (8 * rng.integers(0, 4, (H, W))).astype(np.int32)
    return words, idx, sh


def probe(name: str, fn, *args) -> bool:
    """Run one probe; print OK with its first 4 values, or FAIL with the
    error (the JAX tool's report)."""
    try:
        out = fn(*args)
        print(f"{name}: OK", out.cpu().numpy().ravel()[:4], flush=True)
        return True
    except Exception as e:   # a probe reports its failure, and the run fails
        print(f"{name}: FAIL {str(e)[:200]}", flush=True)
        return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m acmmp_tpu_torch.tools.mosaic_probe",
        description="Lane probes on one (8, 128) tile.")
    ap.add_argument("--device", default=runtime.DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    dev = runtime.resolve_device(args.device)
    words, idx, sh = probe_inputs()
    w, i, s = (torch.as_tensor(a, device=dev) for a in (words, idx, sh))

    ok = all([probe("taa_i32_axis1", probes.run, "taa_i32_axis1", w, i),
              probe("dyn_lane_shift", probes.run, "dyn_lane_shift", w, s),
              probe("unpack4_static", probes.run, "unpack4_static", w),
              probe("taa_i32_axis0", probes.run, "taa_i32_axis0", w, i)])

    got = probes.run("taa_i32_axis1", w, i).cpu().numpy()
    taa_exact = np.array_equal(got, np.take_along_axis(words, idx, axis=1))
    print("taa_i32 exact:", taa_exact, flush=True)
    got = probes.run("dyn_lane_shift", w, s).cpu().numpy()
    want = ((words.astype(np.uint32) >> sh) & 0xFF).astype(np.float32)
    shift_exact = np.array_equal(got, want)
    print("dyn_shift exact:", shift_exact, flush=True)
    return 0 if ok and taa_exact and shift_exact else 1


if __name__ == "__main__":
    sys.exit(main())
