#!/usr/bin/env python3
"""The JAX package beside the port on the plain variant of the DTU method
grid (chip_smoke.py phase 10), on the CPU: a witness for how many points
fusion keeps on that scene that does not come from the port.

    JAX_PLATFORMS=cpu python3 tools/torch_grid_witness.py \
        [--width 320 --height 240 --views 49 --cams 3] \
        [--seeds 0,1,2,3,4] [--handoff]

Like the tests, and unlike the port, this script imports both packages.
It builds phase 10's scan (textured_relief_scene, f = 140 W / 96, spread
1.2, convergent rig), selects the camera subset DTU_CAM_SETS[cams] with
analyze_dtu_scans' ReconParams into one folder per run, and runs each
package's run_pipeline with its default PipelineConfig there: the JAX
package with its plain jnp kernels (no TPU here), the port on the CPU.

Modes (with neither, seed 0 of both packages):
  --seeds S    each package at each seed of S (PipelineConfig.seed); prints
               every count, then per package the min, max and mean, and a
               two-sided Mann-Whitney U test of the two samples (they are
               not paired).
  --handoff    the JAX package one pass at a time on one folder
               (geom_iterations 0, then 1, then 2, each with resume=True),
               the folder copied after each run; then the port resumes each
               copy with its default config (resume=True) and fuses. The
               copy after pass 2 leaves the port only its fusion; then both
               packages' fuse_views of that copy are compared: accept masks,
               consumed masks after every view, points, normals, colours.
               With XLA_FLAGS=--xla_cpu_max_isa=AVX2 the JAX package is
               compiled as for an AVX2 host (ROADMAP.md, rule "Fusion rounds
               as the JAX package's compiled program").
The pipeline at 320x240 takes about 3 minutes on the CPU in the port and
3-7 minutes in the JAX package, most of it compiling."""

from __future__ import annotations

import argparse
import logging
import os
import re
import shutil
import sys
import tempfile
import time

_VIEW_LINE = re.compile(r"fusion view (\d+): (\d+) points accepted")


class _FusionCounts(logging.Handler):
    """Points accepted per reference view, from either package's
    `fusion view %08d: %d points accepted` log line."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def emit(self, record):
        m = _VIEW_LINE.match(record.getMessage())
        if m:
            self.counts[int(m.group(1))] = int(m.group(2))


def _envelope(name, counts):
    return (f"{name}: n={len(counts)} min {min(counts)} max {max(counts)} "
            f"mean {sum(counts) / len(counts):.1f}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--views", type=int, default=49)
    ap.add_argument("--cams", type=int, default=3)
    ap.add_argument("--seeds", default=None,
                    help="comma-separated PipelineConfig.seed values")
    ap.add_argument("--handoff", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch

    from acmmp_tpu.config import PipelineConfig as JaxConfig
    from acmmp_tpu.pipeline.scheduler import run_pipeline as jax_pipeline
    from acmmp_tpu_torch.config import PipelineConfig
    from acmmp_tpu_torch.experiments.dtu_analysis import DTU_CAM_SETS
    from acmmp_tpu_torch.experiments.select_cams import (ReconParams,
                                                         setup_from_source)
    from acmmp_tpu_torch.io import read_ply
    from acmmp_tpu_torch.pipeline.scheduler import run_pipeline
    from acmmp_tpu_torch.utils.synth import (textured_relief_scene,
                                             write_dense_folder)

    torch.set_num_threads(4)
    counter = _FusionCounts()
    logging.getLogger().addHandler(counter)
    w, h = args.width, args.height
    images, cams, _ = textured_relief_scene(
        n_views=args.views, width=w, height=h, f=140.0 * w / 96.0,
        spread=1.2, converge=True)
    subset = DTU_CAM_SETS[args.cams]
    print(f"{w}x{h}, {args.views}-view relief scan, cameras {subset}; CPU",
          flush=True)

    def run(name, dense, **cfg):
        """One package's run_pipeline on `dense`: (points, per-view
        counts, PLY path), or (None, {}, None) where its fusion found no
        depths_geom.dmb (a run without geometric passes)."""
        counter.counts = {}
        t0 = time.perf_counter()
        try:
            if name == "jax":
                ply = jax_pipeline(dense, JaxConfig(**cfg))
            else:
                ply = run_pipeline(dense, PipelineConfig(**cfg),
                                   device="cpu")
        except FileNotFoundError as e:
            print(f"  {name} {cfg}: no fusion ({e.filename})", flush=True)
            return None, {}, None
        n = len(read_ply(ply)[0])
        print(f"  {name} {cfg}: {n} fused points, {n / (w * h):.4f} of a "
              f"view, per view {dict(sorted(counter.counts.items()))}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        return n, dict(counter.counts), ply

    work = tempfile.mkdtemp()
    try:
        scan = write_dense_folder(os.path.join(work, "relief"), images, cams)
        # analyze_dtu_scans' selection parameters
        params = ReconParams(mindist=300, maxdist=800, maxangle=120)

        def folder(tag):
            return setup_from_source(subset, scan, os.path.join(work, tag),
                                     params)

        seeds = ([int(s) for s in args.seeds.split(",")] if args.seeds
                 else ([] if args.handoff else [0]))
        counts = {"jax": [], "port": []}
        for seed in seeds:
            for name in counts:
                n, _, _ = run(name, folder(f"{name}_seed{seed}"), seed=seed)
                counts[name].append(n)
        if len(seeds) > 1:
            from scipy.stats import mannwhitneyu

            print(f"seeds {seeds}", flush=True)
            for name, c in counts.items():
                print("  " + _envelope(name, c), f"{c}", flush=True)
            res = mannwhitneyu(counts["jax"], counts["port"],
                               alternative="two-sided")
            print(f"  Mann-Whitney U {res.statistic:.1f}, two-sided "
                  f"p = {res.pvalue:.4f}", flush=True)
        if args.handoff:
            port_full = (counts["port"][seeds.index(0)] if 0 in seeds
                         else None)
            _handoff(run, folder, work, port_full, np)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


def _handoff(run, folder, work, port_full, np):
    """The JAX package pass by pass, the port from each pass's copy."""
    print("handoff: JAX passes one at a time, the port from each copy",
          flush=True)
    dense = folder("handoff_jax")
    jax_n = []
    for k in range(3):
        jax_n.append(run("jax", dense, geom_iterations=k, resume=True)[0])
        shutil.copytree(dense, os.path.join(work, f"handoff_pass{k}"))
    if port_full is None:
        port_full = run("port", folder("port_seed0"))[0]
    rows = []
    for k in range(3):
        # the port resumes a copy of the JAX package's copy, which stays
        # as that pass left it
        copy = os.path.join(work, f"handoff_port_from_pass{k}")
        shutil.copytree(os.path.join(work, f"handoff_pass{k}"), copy)
        ply = os.path.join(copy, "ACMMP", "ACMMP_model.ply")
        if os.path.exists(ply):
            os.remove(ply)
        rows.append(run("port", copy, resume=True)[0])
    print("handoff summary (JAX passes 0..k, then the port):", flush=True)
    for k, (n, j) in enumerate(zip(rows, jax_n)):
        print(f"  after JAX pass {k}: port {n}, JAX "
              f"{'none (no geometric pass)' if j is None else j}, "
              f"the port's own run {port_full}", flush=True)
    _compare_fusion(os.path.join(work, "handoff_port_from_pass2"), np)


def _compare_fusion(dense, np):
    """Both packages' fuse_views of the JAX package's checkpoints in
    `dense`: accept masks (the debug images), the consumed masks after
    each reference view, and the points, normals and colours."""
    import acmmp_tpu.engine.fusion as jfusion
    from acmmp_tpu.config import FusionParams as JaxFusionParams
    from acmmp_tpu.pipeline.scheduler import (
        generate_sample_list as jax_sample_list)
    from PIL import Image

    from acmmp_tpu_torch.config import FusionParams
    from acmmp_tpu_torch.engine import fusion
    from acmmp_tpu_torch.pipeline.scheduler import generate_sample_list

    out = os.path.join(dense, "ACMMP")
    res = {}
    for name, mod, problems, fp, kw in (
            ("port", fusion, generate_sample_list(dense), FusionParams(),
             dict(device="cpu")),
            ("jax", jfusion, jax_sample_list(dense), JaxFusionParams(), {})):
        views = mod.load_fusion_views(dense, out, problems, True)
        ids = [p.ref_image_id for p in problems]
        masks = []
        debug = os.path.join(dense, f"accept_{name}")
        cloud = mod.fuse_views(
            views, problems, fp, debug_dir=debug, progress=lambda i, n:
            masks.append(np.stack([views[v].mask.copy() for v in ids])),
            **kw)
        accept = np.stack([np.asarray(Image.open(os.path.join(
            debug, f"approved_pixels_cam_{i}.png"))) > 127 for i in ids])
        res[name] = (accept, np.stack(masks), cloud)
    (ta, tm, (tp, tn, tc)), (ja, jm, (jp, jn, jc)) = res["port"], res["jax"]
    print(f"fusion of the JAX checkpoints: accepted per view port "
          f"{ta.sum(axis=(1, 2)).tolist()}, JAX "
          f"{ja.sum(axis=(1, 2)).tolist()}; accept masks equal "
          f"{np.array_equal(ta, ja)}, consumed masks after every view "
          f"equal {np.array_equal(tm, jm)}", flush=True)
    if tp.shape == jp.shape:
        ulp = (np.abs(tp.astype(np.float64) - jp)
               / np.spacing(np.abs(jp).max(1, keepdims=True)))
        print(f"  points bitwise {int((tp == jp).all(1).sum())} of "
              f"{len(jp)}, per coordinate differing "
              f"{(tp != jp).sum(0).tolist()}, at most {ulp.max():.3f} ulp "
              f"of the point's largest coordinate; normals equal "
              f"{np.array_equal(tn, jn)}, colours equal "
              f"{np.array_equal(tc, jc)}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
