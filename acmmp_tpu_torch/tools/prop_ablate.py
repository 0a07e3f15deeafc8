"""Cost decomposition of the ZNCC kernel (csrc/zncc.cu) on the GPU — the
port of the JAX package's ``tools/prop_ablate.py``.

It times the K = 8 propagation stack, the solver's most expensive call,
in five modes of csrc/ablate.cu that switch parts of the per-tap work off
(ops/ablate.py says what each keeps), on a stand-in converged field: the
relief scene's ground-truth surface planes and 8 neighbour-shifted copies
of them as the propagation candidates, offsets (0, +-1), (0, +-5),
(+-1, 0), (+-5, 0), parity-packed as a half-sweep scores them:

  full      zncc.cu's arithmetic, unchanged
  noext     no bilinear weights, centring or moments per tap
  nobounds  the per-tap placement only at tap 0
  noscan    no source reads
  f32take   full on f32 sources; runs only if the f32 gather probe
            (nan_take_probe) keeps every bit pattern

    python -m acmmp_tpu_torch.tools.prop_ablate [--height 1184 --width 1600
        --views 8] [--reps 3] [--modes full,noext,nobounds,noscan,f32take]
        [--device cuda]

It runs on CUDA unless ``--device cpu`` is given (there the plain
versions run, for a check of the path at a small size). On CUDA it
prints the card's name and power limit, then one JSON line: tool, shape,
views, times_ms (ms per call, CUDA events after a warm-up; wall-clock
ms on the CPU), f32_take_bit_exact and device."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from acmmp_tpu_torch import runtime
from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.core import geometry as geo
from acmmp_tpu_torch.engine.inputs import build_solver_inputs
from acmmp_tpu_torch.ops import ablate, cuda_ablate
from acmmp_tpu_torch.ops import ncc as ncc_ops
from acmmp_tpu_torch.ops import parity, probes
from acmmp_tpu_torch.utils.synth import textured_relief_scene

# the propagation candidates' offsets (dx, dy): the checkerboard regions'
# reach, near +-1 px and far +-5 px (ACMMP.cu:804-992)
CANDIDATE_OFFSETS = ((0, -1), (0, -5), (0, 1), (0, 5), (-1, 0), (-5, 0),
                     (1, 0), (5, 0))


def build_fields(height: int, width: int, views: int, device=None):
    """The relief scene's converged stand-in field on `device`: the
    surface planes of view 0's ground-truth depth (normals from its
    gradient) and the 8 candidate fields, parity-packed at off0. Returns
    (params, inputs, vg, cand_pk [8, H // 2, W, 4], off0)."""
    dev = runtime.resolve_device(device)
    params = PatchMatchParams()
    images, cams, gt = textured_relief_scene(
        n_views=views + 1, width=width, height=height,
        f=140.0 * width / 96.0, spread=1.2, converge=True)
    inputs = build_solver_inputs(images[0], images[1:], cams[0], cams[1:],
                                 params, device=dev)
    vg = ncc_ops.make_view_geometry(inputs.ref_cam, inputs.src_cams)
    H, W = inputs.ref_img.shape
    x, y = geo.pixel_grid(H, W, device=dev)
    gt_pad = np.pad(gt, ((0, H - gt.shape[0]), (0, W - gt.shape[1])),
                    mode="edge")
    depth = torch.as_tensor(gt_pad, device=dev)
    # normal from the depth gradient (first-order differences at the
    # edges, as jnp.gradient): the field's slopes, not exact normals
    dzdx = torch.gradient(depth, dim=1)[0]
    dzdy = torch.gradient(depth, dim=0)[0]
    n_world = torch.stack([-dzdx * 50, -dzdy * 50, -torch.ones_like(depth)],
                          dim=-1)
    n_world = n_world / torch.linalg.norm(n_world, dim=-1, keepdim=True)
    n_cam = geo.normal_world_to_cam(inputs.ref_cam, n_world)
    planes = geo.plane_from_depth_normal(inputs.ref_cam, x, y, depth, n_cam)
    cand = torch.stack([torch.roll(planes, (dy, dx), dims=(0, 1))
                        for dx, dy in CANDIDATE_OFFSETS])
    pm = ((x.int() + y.int()) % 2) == 0
    off0 = parity.row_pack_offset(pm)
    cand_pk = parity.pack_rows_c(cand, off0).contiguous()
    return params, inputs, vg, cand_pk, off0


def ablate_call(mode, ref_img, src_imgs, vg, planes, params, off0, n_views,
                prep=None):
    """Costs of `mode` on packed planes [8, Hg, W, 4] -> [8, Hg, W, V]:
    the kernel for CUDA tensors (`prep` from cuda_ablate.prepare, built
    here if None), the plain version for CPU tensors."""
    if planes.is_cuda:
        if prep is None:
            prep = cuda_ablate.prepare(ref_img, src_imgs, vg, params, off0)
        return cuda_ablate.ablate_cuda(mode, planes, prep, params, n_views)
    return ablate.ablate_packed(mode, ref_img, src_imgs, vg, planes, params,
                                off0)


def adversarial_words(seed: int = 0):
    """nan_take_probe's inputs (prop_ablate.py:436-449): random 32-bit
    words with signalling and quiet NaNs, +inf, -0 and negative
    signalling NaNs planted, lane indices and selects. Returns numpy
    (words int32 [8, 128], idx int32, sel bool)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 32, (8, 128), dtype=np.uint32)
    words[0, :16] = 0x7F800001            # sNaN
    words[0, 16:32] = 0x7FC00000          # qNaN
    words[0, 32:48] = 0x7F800000          # +inf
    words[0, 48:64] = 0x80000000          # -0
    words[1, :64] = 0xFF800001            # -sNaN
    idx = rng.integers(0, 128, (8, 128)).astype(np.int32)
    sel = rng.integers(0, 2, (8, 128)) == 1
    return words.view(np.int32), idx, sel


def nan_take_probe(device=None) -> bool:
    """Whether a gather and select through f32 registers is bit-exact on
    arbitrary words: take_select_f32 against take_select_i32."""
    dev = runtime.resolve_device(device)
    args = [torch.as_tensor(a, device=dev) for a in adversarial_words()]
    a = probes.run("take_select_i32", *args)
    b = probes.run("take_select_f32", *args)
    ok = bool(torch.equal(a, b))
    print(f"nan_take_probe: f32 take/select bit-exact = {ok}", flush=True)
    return ok


def time_ms(fn, reps: int, dev: torch.device) -> float:
    """ms per call of `fn` after one warm-up call: CUDA events on the
    card, the wall clock on the CPU."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(dev)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def run_modes(fields, modes, reps: int):
    """The tool's work after the fields: the probe, then each mode timed
    (f32take skipped if the probe fails). Returns ({mode: ms per call},
    whether the probe passed)."""
    params, inputs, vg, cand_pk, off0 = fields
    dev = cand_pk.device
    nv = int(inputs.view_mask.sum())
    probe_ok = nan_take_probe(dev)
    prep = None
    if dev.type == "cuda":
        prep = cuda_ablate.prepare(inputs.ref_img, inputs.src_imgs, vg,
                                   params, off0)
    results = {}
    for mode in modes:
        if mode == "f32take" and not probe_ok:
            print("f32take: SKIPPED (probe failed)", flush=True)
            continue

        def run(mode=mode):
            return ablate_call(mode, inputs.ref_img, inputs.src_imgs, vg,
                               cand_pk, params, off0, nv, prep)

        total = float(run().sum())
        ms = time_ms(run, reps, dev)
        results[mode] = ms
        print(f"{mode:9s}: {ms:9.4f} ms/call   [sum={total:.3e}]",
              flush=True)
    return results, probe_ok


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m acmmp_tpu_torch.tools.prop_ablate",
        description="Cost decomposition of the ZNCC kernel's K=8 stack.")
    ap.add_argument("--height", type=int, default=1184)
    ap.add_argument("--width", type=int, default=1600)
    ap.add_argument("--views", type=int, default=8,
                    help="source views (the scene has one more)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--modes", default=",".join(ablate.MODES))
    ap.add_argument("--device", default=runtime.DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    modes = [m for m in args.modes.split(",") if m]
    bad = [m for m in modes if m not in ablate.MODES]
    if bad:
        ap.error(f"unknown modes {bad}; choose from {ablate.MODES}")
    dev = runtime.resolve_device(args.device)

    t0 = time.monotonic()
    fields = build_fields(args.height, args.width, args.views, dev)
    print(f"# fields built {time.monotonic() - t0:.1f}s", flush=True)
    results, probe_ok = run_modes(fields, modes, args.reps)

    if dev.type == "cuda":
        print(card_line(), flush=True)
    print(json.dumps({"tool": "prop_ablate",
                      "shape": f"{args.width}x{args.height}",
                      "views": args.views, "times_ms": results,
                      "f32_take_bit_exact": probe_ok,
                      "device": (torch.cuda.get_device_name(dev)
                                 if dev.type == "cuda" else "cpu")}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
