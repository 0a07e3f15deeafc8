#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (acmmp_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
  3. hold the ZNCC kernel against its plain PyTorch version on the card,
     on the 320x240 / 4-source bench scene: K=1 on the full grid, K=8/3/2
     on the parity-packed grid, coherent and random planes under both
     random laws, a padded view slot, K-stacks bitwise equal to K
     separate K=1 launches, every packed K=8 stack bitwise equal to
     the kernel's first design (csrc/ablate.cu `full`), and the kernel's
     float-source instantiation on these u8-valued floats bitwise equal
     to its 8-bit one; then again at the main paths' own shapes
     (1600x1184 and 800x592, 8 sources, K=8 coherent and random under
     both laws);
  3e. (run after 3b) float sources (PatchMatchParams(ncc_src_u8=False))
     through the kernel: the same checks on real-valued sources at
     320x240 / 4 sources (+1 padded slot) and 1600x1184 / 8 sources (the
     K=8 stacks bitwise equal to the first design on f32 sources,
     csrc/ablate.cu `f32take`), the 96x64 relief solve at
     tests/test_relief.py's bars, and a 320x240 solve, kernel against
     plain version, at phase 4's bar;
  3f. (run after 3c) the batched launches, one launch for B = 3
     reference views (view 1 with a padded source slot) at 320x240 / 4
     sources and 1600x1184 / 8 sources: zncc.cu K=1 on the full grid and
     K=8/3/2 packed at both parities, 8-bit and float sources, and
     geom.cu K=1, 8 and 5, each torch.equal to the same views'
     single-view launches and held to its batched plain version at the
     single-view bars;
  3c. hold the geometric-consistency kernel bitwise (torch.equal) to its
     plain version and to its first design on a non-round rig at 320x240
     / 4 sources (+1 padded slot), 800x592 and 1600x1184 / 8 sources: K=1
     on the full grid, K=8 and K=5 packed at both parities, off-plane and
     random planes, smooth depth maps and a zeroed band;
  4. a full 320x240 solve through the kernel and through the plain
     version with the same key; report the depth agreement;
  5. the photometric main path: the 1600x1184 / 8-source solve with the
     shipping PatchMatchParams(), warm-up then timed; 13 kernel launches
     per solve; median interior depth error below 0.15; then (5b) the
     same solve on float sources, 13 launches of the float-source
     instantiation; then (5c) the batched executor: reference views 0-3
     of phase 8's scene (8 sources each) in one solve_batch at 1600x1184
     and at 800x592, 13 ZNCC launches for the batch, each view
     torch.equal to its own run_patchmatch and under 0.15 median error,
     the batch and the views one by one timed in turns, one batched and
     one single solve profiled (device busy, idle share), and the
     batched kernels timed per launch at B = 4 beside their plain
     versions and bounds;
  6. per-launch kernel times at the main paths' shapes beside the plain
     version and the bound (ZNCC on 8-bit and on float sources), each
     ZNCC K's and geom's ptxas registers and blocks per SM (occupancy
     calculator), zncc.cu K=8 against its first design timed in turns
     (first, new, new, first) on the random field at 1600x1184, which it
     must beat at its PR-5 ratio, and geom.cu K=8 and K=5 likewise
     against its first design, which it must beat;
  7. ACMMP's per-view two-scale chain at full width on arrays: 3 of the
     9 views (0, 4, 8), each the reference with the other 2 as sources
     (phase 8 runs the same schedule on all 9 through the disk), at
     800x592 (photometric,
     planar-prior second solve, two geometric passes), JBU to 1600x1184,
     then hierarchy, hierarchy + planar prior and two geometric passes;
     9 geom and 13 ZNCC launches per geometric solve; view 0's final
     depth within the bars of tests/test_patchmatch.py (median < 0.15,
     more than 85% under 0.5, at most 1.5x the error of a photometric
     1600x1184 solve of the same view);
  3d. (run after 3c) hold the fusion sampler kernel bitwise against its
     plain version: the five cases of tests/test_pallas_sample.py, then
     fusion's shapes (8 views, 4 and 8 channels, 800x592 and 1600x1184)
     with index fields from real projections and 10% invalid lanes that
     carry garbage indices; phase 6 times it on fusion's projected fields
     (lanes projected out of view invalid) beside the bytes those inputs
     make it move, the plain version and one torch.gather;
  8. the pipeline at full width: phase 7's scene written as a 9-view
     1600x1184 dense folder (JPEG, 8 sources each) goes through
     run_pipeline on the card (the scheduler resizes to 800x592: 72
     solves, 9 JBUs, plain fusion) to a PLY; the .dmb layout and sizes,
     the launch counts of every kernel, view 0's final depth against
     phase 7's bars (its yardstick view 0's photometric solve with its 8
     sources), the fused cloud against its bars, and the fusion's sampler
     launches timed with CUDA events beside their bound; then the same
     fusion through the plain sampler (the PLY bytes must be equal), and
     a prior-aware fusion with a x1.002 second candidate through the
     kernel and through the plain version (equal PLY bytes); then (8b)
     the first PHASE8B_VIEWS views of the scene as a dense folder of
     their own through run_pipeline with view_batch=4 (batches of 4 and
     1): its launches (one solve's per batch), stage walls and the cloud
     at phase 8's bars;
  9. (run after 6) the ZNCC cost decomposition and the lane probes:
     the six probes of csrc/probes.cu bitwise against their plain
     versions and numpy, on the probe tool's words and on
     nan_take_probe's adversarial ones, timed beside torch.gather /
     torch.where; prop_ablate's converged relief field built at its
     defaults (1600x1184, 8 sources) and its main path run (the f32
     gather probe, every ablation mode timed, then mosaic_probe) with the
     launch counts reset; then, on that field and on phase 6's random
     K=8 field, each mode of csrc/ablate.cu against its plain version
     (full bitwise equal to zncc.cu K=8, f32take bitwise equal to full,
     nobounds at the ZNCC bar, noext and noscan within 1e-5 (1 + |x|)),
     timed, zncc.cu K=8 timed in turns against `full` (it must beat it
     here too), and the decomposition of the first design printed (loads
     = full - noscan, bilinear and moments = full - noext, per-tap
     placement = full - nobounds, u8 against f32 reads = f32take - full);
     last, each mode's and each zncc.cu K's ptxas registers and SASS
     counts (cuobjdump): loads, reciprocals, conversions (I2F, F2I, FRND),
     PRMT, LDS, stores and local memory, with zncc.cu's tap loop held to
     one 32-bit source word (one 16-byte quad on float sources), one
     MUFU.RCP and no conversion or local memory per (hypothesis, tap) at
     every K, and geom.cu's view loop to 6 MUFU.RCP per (hypothesis,
     view), its stores (one 16-byte store per four views where V is a
     multiple of 4) and no local memory;
  10. (run after 8b) the rest of the CLI and the DTU method grid, through
     acmmp_tpu_torch.cli.main: make-synthetic --relief (MADE_VIEWS views
     at 320x240) byte-equal to the library call, the grid's 49-view
     relief scan on the full-scale tool's convergent rig with its
     ground-truth PLY (relief_gt_points), and analyze-dtu --cam_counts
     3,5 --gt_root on the card, launch counts set to 0 just before it and
     read just after: every subset has its five variant PLYs (no_prior,
     x2, boost_1, boost_single, full_prior) above GRID_MIN_FUSED_SHARE of
     a view, 12 finite metrics each, the paired tests printed, 13 ZNCC
     launches per solve with the seeded solves among them, sample.cu
     launches by width (counted by its wrapper) adding up to its launches
     and C=8 in x2 and boost_1 only; then select-cams, eval-dtu --json
     and make-priors through the CLI equal to the grid's folder and the
     library calls;
  10b. fullscale_quality at its defaults (1280x960, 6 views, the default
     random law): its 12 metrics at FULLSCALE_BARS, its walls (the
     evaluation on a line of its own) and its launch counts;
  11. the device mesh on this card, MESH_MEMBERS members that all sit
     on it (parallel/): (11c, run after 8b) phase 8's dense folder
     through run_pipeline on a view mesh, the planar-prior second solve
     at the coarse scale only: the launches of batches padded
     to the mesh, no source .dmb read in the geometric passes (the
     depth-file reads counted), the cloud at phase 8's bars and the
     mesh fusion's PLY bytes equal to the sequential fusion's of the
     same checkpoints; (11a, after 10b) geom.cu at K = 1, 8 and 5, full
     and packed, at the tile origin TILE_ORIGIN and at (0, 0)
     torch.equal to its plain version (at (0, 0) also to its first
     design), K=8 timed in turns at both origins, and zncc.cu K=1 and
     K=8 at the origin against plain at the ZNCC bar; (11b) a 3200x2368
     / 8-source view (above tile_pixels) solved with its rows over a
     tile mesh, photometric and geometric, torch.equal to the untiled
     solve, 13 ZNCC launches per member (9 geom), walls of both;
  12. (run after 11c) two processes on this card, one global mesh of two
     members (parallel/multihost.py): `python -m acmmp_tpu_torch.cli
     reconstruct <folder> --mesh` started twice with the torchrun
     variables (both own cuda:0), on a copy of phase 8b's folder (views
     0-4) with 11c's cut (planar_prior_max_pixels); the yardstick is
     run_pipeline in this process on another copy over a single-process
     mesh of cuda:0 twice. Every .dmb file, pass marker and the PLY are
     byte-equal, rank 1 wrote no file (each rank counts its writes and
     logs the count), each rank's zncc.cu launches are 13 per solve of
     its own member, the cloud meets phase 8's bars; a child that exits
     non-zero or outlives PHASE12_TIMEOUT_S fails the phase; the walls of
     both runs and each rank's are printed;
then the kernel table as one JSON line, the card line and the result
line. Lines near the start say which of cv2, matplotlib, PIL and scipy
import here, and how long read_png takes on 1600x1200 normal priors that
OpenCV wrote, each held to OpenCV's decode (information: the times are
not bounded).

Imports nothing of JAX. Exits non-zero without a result when there is no
CUDA device or when the acmmp_tpu_torch package is not beside it.
"""

from __future__ import annotations

import dataclasses
import filecmp
import json
import logging
import math
import os
import pathlib
import statistics
import subprocess
import sys
import shutil
import tempfile
import time

import numpy as np

# ZNCC bar of the JAX package's kernel tests (tests/test_pallas_ncc.py):
# fewer than 0.1% of costs may differ by more than 2e-3 + 1e-3 |ref|
ZNCC_ATOL, ZNCC_RTOL, ZNCC_MAX_FRAC = 2e-3, 1e-3, 1e-3
# solve-level agreement, kernel against plain version with the same key:
# 95% of interior depths within 1%. Both are the port's centred f32 ZNCC,
# so they agree far better than the port and the JAX package do on the
# CPU (tests/test_torch_solver.py pins 80% within 1% there)
SOLVE_REL_TOL = 0.01
SOLVE_MIN_SHARE = 0.95
# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the tensor
# cores, HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# FP32 operations per (hypothesis, view, tap, pixel) evaluation of
# csrc/zncc.cu, counting an FMA as two (see the tally in the source note)
OPS_PER_TAP_EVAL = 40

# the geom kernel must equal its plain version bitwise; the share of costs
# beyond the JAX package's geom bar (tests/test_pallas_geom.py: fewer than
# 2e-3 may differ by more than 1e-3 + 1e-3 |ref|) is logged beside it
GEOM_ATOL, GEOM_RTOL = 1e-3, 1e-3
# FP32 operations of csrc/geom.cu per (hypothesis, view, pixel) and per
# (view, pixel), from the tally in its source note
GEOM_OPS_PER_EVAL = 141
GEOM_OPS_PER_PIXEL_VIEW = 6
GEOM_TPU_KERNEL = "acmmp_tpu/ops/pallas_geom.py:49"
# IEEE divisions (one MUFU.RCP each) per (hypothesis, view) in geom.cu's
# view loop: two projections and a world point
GEOM_RCP_PER_VIEW = 6
# zncc.cu K=8 over its first design (csrc/ablate.cu `full`), timed in
# turns on phase 6's random field and on phase 9's converged one before
# the kernel took a second source type (PERF.md, Findings); the 8-bit
# instantiation must stay within 1% of these
ZNCC_U8_RATIO_PR5 = {"random": 0.5446, "converged": 0.5647}
ZNCC_U8_RATIO_SLACK = 1.01
# tests/test_relief.py's bars on the 96x64 relief solve (patch_size=7):
# median interior error, share under 0.2, correlation with the truth
RELIEF_MEDIAN_BAR, RELIEF_SHARE_BAR, RELIEF_CORR_BAR = 0.05, 0.85, 0.85
# the chain's bars on view 0's final depth, those of
# tests/test_patchmatch.py::test_geometric_pass_refines: median interior
# error, share under 0.5, and the ratio to a photometric solve of the same
# view at the same scale
CHAIN_MEDIAN_BAR, CHAIN_SHARE_BAR, CHAIN_RATIO_BAR = 0.15, 0.85, 1.5
# the chain's scene: the texture's frequencies x 24, so that its shortest
# wavelength is 22 px at 800x592 (f = 1500) and 45 px at 1600x1184 (f =
# 3000), about a patch. At the default texture (shortest wavelength 540
# and 1080 px) every patch is near-linear and a wrong depth costs less
# than the right one (tools/torch_chain_quality.py), so no bar could tell
# a right chain from a wrong one
CHAIN_TEXTURE_SCALE = 24.0

# the fusion sampler (csrc/sample.cu) and its yardstick shapes: fusion
# reads 8 source views at 4 channels (plain) or 8 (prior-aware)
SAMPLE_TPU_KERNEL = "acmmp_tpu/ops/pallas_sample.py:32"
SAMPLE_CHANNELS = (4, 8)
SAMPLE_INVALID_SHARE = 0.1
# phase 8b runs the batched executor on the first 5 of the 9 views
# (batches of 4 and 1): three 9-view pipelines (8, 8b, 11c), each most of
# it the host's planar-prior build, would not fit the script in its time
PHASE8B_VIEWS = 5
# phase 7 runs the chain on these 3 of the 9 views (baselines 0.25 and
# 0.5 around view 0): every mode and both solver kernels, while phase 8
# runs the schedule on all 9
CHAIN_VIEWS = (0, 4, 8)
# the fused cloud of phase 8 (9 views of the textured plane at 1600x1184):
# median |z - plane| and the share of points under 0.5, in the spirit of
# tests/test_pipeline.py::test_full_pipeline_synthetic (0.1 and 0.9 at
# 64x48) but calibrated to this scene, whose chain ends at a median depth
# error near 2e-4: a chain on the default texture ended at 0.0295
# (PERF.md, Findings) and would fail the median bar; at least a quarter of
# a view's pixels must be fused
FUSED_MEDIAN_BAR, FUSED_SHARE_BAR, FUSED_MIN_VIEW_SHARE = 0.005, 0.99, 0.25

# phase 9: the ZNCC cost decomposition (csrc/ablate.cu) and the lane
# probes (csrc/probes.cu), with the TPU kernels they replace. FP32
# operations per (hypothesis, view, tap, pixel) of each ablation mode, from
# the tally in csrc/ablate.cu's source note, and the bytes per source pixel
# each reads (none in noscan, f32 words in f32take)
ABLATE_TPU_KERNEL = "tools/prop_ablate.py:97"
ABLATE_OPS_PER_TAP_EVAL = {"full": 41, "noext": 26, "nobounds": 18,
                           "noscan": 41, "f32take": 41}
ABLATE_SRC_BYTES = {"full": 1, "noext": 1, "nobounds": 1, "noscan": 0,
                    "f32take": 4}
# modes held to their plain version within 1e-5 (1 + |x|) at the shipped
# params, where their costs are cost_max (up to noscan's leak); the others
# at the ZNCC bar
ABLATE_CLOSE = ("noext", "noscan")
# The same two under ops/ablate.EXPOSING, where their costs rest on the
# sums they keep, both versions reading the 8-bit sources: the share of
# the informative costs that must lie within 1e-5 of the plain version's,
# relative. It is under 1 because the placement differs in rounding (the
# kernel's fmaf homography against the plain version's separate
# products), so a corner now and then floors to the next pixel: that
# moves one tap's raw sum in noext and one read offset in noscan (by up
# to 4e-3 of a small sum, near the view's first rows), or a centre lands
# in bounds in one version and out in the other; elsewhere both compute
# the same rounded operations.
# At least ABLATE_INFORMATIVE_MIN of the costs must be informative.
ABLATE_EXPOSED_SHARE = 0.99
ABLATE_INFORMATIVE_MIN = 0.2
# Every mode is timed at its own occupancy and at 3 blocks of 128 threads
# per SM, what the registers of full, f32take and nobounds (137-140) allow
# and noext and noscan (123-128) exceed, so that a mode's saving is the
# work it removed and not a fourth block. The kernel uses no shared
# memory; a launch asks for (bytes of dynamic shared memory, carveout
# preference in percent or -1 for the driver's): 64 KB per block (1 KB
# more reserved) fits 3 blocks in an SM's 228 KB and not 4 at any
# carveout, leaving at most 60 KB of L1; 20 KB under a 28% carveout (64
# KB) fits 3 and not 4 with about 192 KB of L1, if the driver keeps the
# preference. `full` at its own occupancy against these shows what the
# smaller L1 costs it.
ABLATE_EQUAL_BLOCKS = 3
ABLATE_EQUAL_OCCUPANCY = (("smem 64 KB", 64 * 1024, -1),
                          ("smem 20 KB, carveout 28%", 20 * 1024, 28))
ABLATE_SHAPE = (1600, 1184, 8)      # the tool's defaults: width, height, views
PROBE_TPU_KERNEL = {"taa_i32_axis1": "tools/mosaic_probe.py:36",
                    "taa_i32_axis0": "tools/mosaic_probe.py:53",
                    "dyn_lane_shift": "tools/mosaic_probe.py:40",
                    "unpack4_static": "tools/mosaic_probe.py:45",
                    "take_select_i32": "tools/prop_ablate.py:451",
                    "take_select_f32": "tools/prop_ablate.py:455"}

# phase 10: the DTU method grid through the CLI on a 49-view relief scan
# at 320x240 (as many views as DTU_CAM_SETS names), camera subsets of 3
# and 5. The scan's rig is the full-scale tool's (f = 140 W / 96, spread
# 1.2, convergent): make-synthetic's relief rig is parallel, so
# select-cams' 3-degree window would pair none of its views. Each fused
# variant must hold at least GRID_MIN_FUSED_SHARE of one view's pixels:
# fusion's dynamic consistency (exp(-(err + 200 rdd + 10 angle)) above 0.3
# per consistent view) keeps few of this scene's pixels, so the 3-camera
# plain variant fused 8,239 points on the CPU (0.107 of a view; 42,517
# with that test off); a broken solve or fusion lands near 0
GRID_SHAPE = (320, 240, 49)         # width, height, views
MADE_VIEWS = 4                  # make-synthetic, held to the library call
GRID_CAM_COUNTS = (3, 5)
GRID_MIN_FUSED_SHARE = 1 / 16
# each variant of analyze_scene: its pipeline's output_dir and its PLY
GRID_VARIANTS = {"no_prior": ("ACMMP", "ACMMP_no_prior.ply"),
                 "x2": ("ACMMP2", "ACMMP_x2.ply"),
                 "boost_1": ("ACMMP_BOOST", "acmmp_boost_1.ply"),
                 "boost_single": ("ACMMP_BOOST_SINGLE",
                                  "acmmp_boost_single.ply"),
                 "full_prior": ("ACMMP_full_prior", "ACMMP_full_prior.ply")}
# phase 10b: fullscale_quality at its defaults (1280x960, 6 views, default
# random law) held to about 0.8x round 5's default-law acc2 and cmp2
# (0.4811, 0.4347; QUALITY_fullscale_r05.json) and 1.25x its acc_mean
# (5.61 mm): a broken port lands near 0
FULLSCALE_BARS = {"acc2": 0.38, "cmp2": 0.35, "acc_mean": 7.0}

# phase 11: the device mesh on one card, a mesh of MESH_MEMBERS members
# that all sit on it. 11b: a view above PipelineConfig().tile_pixels
# (4,000,000) with its rows over the members, 592 rows each (H = 2368 =
# 74 x 32); 11a times geom.cu at member 1's extended origin (592 - 24)
MESH_MEMBERS = 4
TILE_SHAPE = (3200, 2368, 8)        # width, height, sources: 7.58 MP
# 11c skips the planar-prior second solve above this many pixels: at the
# fine scale (1600x1184), not at the coarse one (800x592). The fine
# scale's host prior build is most of a 9-view pipeline's wall, and the
# script runs phase 8's schedule three times (8, 8b, 11c)
PHASE11C_PRIOR_MAX_PIXELS = 1_000_000
TILE_ORIGIN = (568, 0)
# phase 12: two processes on the card, one member each; a child still
# running after this many seconds is killed and fails the phase
PHASE12_RANKS = 2
PHASE12_TIMEOUT_S = 420

TPU_KERNEL = {1: "acmmp_tpu/ops/pallas_ncc.py:108",
              2: "acmmp_tpu/ops/pallas_ncc.py:542",
              3: "acmmp_tpu/ops/pallas_ncc.py:542",
              8: "acmmp_tpu/ops/pallas_ncc.py:542"}


# (phase label, when it started), for the walls by phase
PHASE_STARTS = []


def log(msg):
    print(msg, flush=True)


def mark(label):
    """The phase `label` starts now."""
    PHASE_STARTS.append((label, time.perf_counter()))


def phase_walls(end):
    """Seconds from each phase's mark to the next one's, summed by label."""
    walls = {}
    for (label, t), (_, t_next) in zip(
            PHASE_STARTS, PHASE_STARTS[1:] + [("end", end)]):
        walls[label] = walls.get(label, 0.0) + t_next - t
    return ", ".join(f"{k} {v:.1f}" for k, v in walls.items())


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def interior_error(depth, width, height, plane_z):
    """(median |depth - z|, share under 0.5) on the interior
    [0.2, 0.8) x [0.19, 0.81) of the true extent width x height (phase
    5's)."""
    import torch

    r0, r1 = int(0.2 * height), int(0.8 * height)
    c0, c1 = int(0.19 * width), int(0.81 * width)
    err = (torch.as_tensor(depth)[r0:r1, c0:c1] - plane_z).abs().float()
    return err.median().item(), (err < 0.5).float().mean().item()


def photometric_yardstick(scene, dev):
    """The yardstick of the 1.5x rule: view 0's photometric solve at the
    scene's scale, every other view a source, with the key of its first
    pass in the scheduler (scheduler.py:347-348). Returns its interior
    error (median, share under 0.5)."""
    from acmmp_tpu_torch.config import PatchMatchParams, PipelineConfig
    from acmmp_tpu_torch.engine.inputs import build_solver_inputs
    from acmmp_tpu_torch.engine.patchmatch import Mode, run_patchmatch
    from acmmp_tpu_torch.ops import keys

    images, cams, plane_z = scene
    params = PatchMatchParams()
    inputs = build_solver_inputs(images[0], images[1:], cams[0], cams[1:],
                                 params, device=dev)
    key = keys.fold_in(keys.key(PipelineConfig().seed), 0)
    out = run_patchmatch(inputs, key, params, Mode())
    H, W = images[0].shape
    assert bool(out.depth[:H, :W].isfinite().all())
    return interior_error(out.depth[:H, :W], W, H, plane_z)


def sample_bytes(maps, rr, cc, valid):
    """The bytes the fusion sampler must move on these inputs, a 0-d
    tensor on their device (no host sync): `valid` for every lane, `rr`
    and `cc` for the valid lanes only, the C words of every distinct
    source pixel that a valid lane reads, and the output. An invalid lane
    reads neither its indices nor the maps."""
    import torch

    V, C, Hs, Ws = maps.shape
    v = torch.arange(V, device=maps.device).view(V, 1, 1)
    flat = torch.where(valid, (v * Hs + rr.long()) * Ws + cc.long(), -1)
    s = torch.sort(flat.flatten()).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    distinct = (first & (s >= 0)).sum()
    return valid.numel() * (1 + 4 * C) + 8 * valid.sum() + 4 * C * distinct


def run_chain(scenes, dev, card):
    """Phase 7: ACMMP's per-view two-scale chain as run_pipeline schedules
    it (acmmp_tpu/pipeline/scheduler.py:724-765), with arrays in place of
    the .dmb files. `scenes` maps (width, height) to a scene of the same
    views at that scale; each view in turn is the reference and the others
    its sources. The coarse scale is rendered directly at 800x592 (f =
    1500; its principal point is (W-1)/2 of that size, a quarter pixel
    from a resize of the 1600x1184 view). View 0's final depth is held to
    the bars and to a photometric solve of view 0 at the fine scale.
    Returns the chain's launch counts by kernel."""
    import torch

    from acmmp_tpu_torch.config import PatchMatchParams, PipelineConfig
    from acmmp_tpu_torch.engine.inputs import build_solver_inputs
    from acmmp_tpu_torch.engine.patchmatch import Mode, run_patchmatch
    from acmmp_tpu_torch.engine.priors import build_planar_prior
    from acmmp_tpu_torch.ops import cuda_geom, cuda_ncc, keys
    from acmmp_tpu_torch.ops.jbu import jbu_depth, jbu_normal_cost

    params, cfg = PatchMatchParams(), PipelineConfig()
    n_sweeps = 2 * params.max_iterations
    want_zncc = {1: 1, 8: n_sweeps, 3: n_sweeps, 2: n_sweeps}
    want_geom = {1: 1, 8: n_sweeps, 5: n_sweeps}
    no_geom = {k: 0 for k in cuda_geom.SUPPORTED_K}
    coarse, fine = sorted(scenes)
    n_views = len(scenes[coarse][0])
    label = {s: f"{s[0]}x{s[1]}" for s in scenes}
    dev_ms, prior_s = {}, {coarse: 0.0, fine: 0.0}

    def problem_key(rid, tag):
        # scheduler.py:347-348
        return keys.fold_in(keys.key(cfg.seed), rid * 131 + tag)

    def solve(scale, i, mode, key, name, **maps):
        images, cams, _ = scenes[scale]
        src = [j for j in range(n_views) if j != i]
        inputs = build_solver_inputs(
            images[i], [images[j] for j in src], cams[i],
            [cams[j] for j in src], params, device=dev, **maps)
        z0, g0 = dict(cuda_ncc.launches), dict(cuda_geom.launches)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = run_patchmatch(inputs, key, params, mode)
        b.record()
        torch.cuda.synchronize()
        dev_ms.setdefault(name, []).append(a.elapsed_time(b))
        w, h = scale
        for t in out:
            # the true extent, which the pipeline keeps
            assert torch.isfinite(t[:h, :w]).all(), (name, i)
        if i == 0:
            dz = {k: cuda_ncc.launches[k] - z0[k] for k in z0}
            dg = {k: cuda_geom.launches[k] - g0[k] for k in g0}
            med, share = scale_error(scale, out.depth[:h, :w])
            log(f"  view 0 {name}: zncc launches {dz}, geom {dg}, "
                f"{dev_ms[name][-1]:.1f} ms; median interior |depth - z| "
                f"{med:.5f}, share < 0.5 {share:.4f}")
            assert dz == want_zncc, (name, dz)
            assert dg == (want_geom if mode.geom_consistency else no_geom), (
                name, dg)
        return out

    def scale_error(scale, depth):
        return interior_error(depth, *scale, scenes[scale][2])

    def on_host(scale, out):
        """The maps a pass leaves for the next one ([:h, :w], the .dmb
        contract): depth, world normal, cost."""
        w, h = scale
        return tuple(t[:h, :w].cpu().numpy()
                     for t in (out.depth, out.normal_world, out.cost))

    def prior_solve(scale, i, out, key, name, hierarchy):
        """The planar-prior second solve (scheduler.py:296-336, 396-404):
        the prior is built on the host from the first solve's output."""
        images, cams, _ = scenes[scale]
        w, h = scale
        cam = cams[i]
        dmin = float(cam.depth_min * params.depth_min_relax)
        dmax = float(cam.depth_max * params.depth_max_relax)
        depth, normal, cost, pre = (t.cpu().numpy() for t in (
            out.depth, out.normal_world, out.cost, out.pre_costs))
        t0 = time.perf_counter()
        planes, mask = build_planar_prior(cam, depth[:h, :w], cost[:h, :w],
                                          dmin, dmax, w, h)
        prior_s[scale] += time.perf_counter() - t0
        assert planes is not None, (name, i)
        return solve(scale, i, Mode(planar_prior=True, hierarchy=hierarchy),
                     keys.fold_in(key, 1), name, init_depth=depth,
                     init_normal_world=normal, init_cost=cost,
                     prior_planes=planes, prior_mask=mask,
                     pre_costs=pre if hierarchy else None)

    def geom_passes(scale, maps, tag):
        """cfg.geom_iterations geometric passes; pass 2 reads the other
        views' pass-1 depths (multi_geometry, scheduler.py:257)."""
        for it in range(cfg.geom_iterations):
            new = {}
            for i in range(n_views):
                d, n, c = maps[i]
                out = solve(scale, i, Mode(geom_consistency=True),
                            problem_key(i, tag),
                            f"{label[scale]} geom {it + 1}",
                            src_depths=[maps[j][0] for j in range(n_views)
                                        if j != i],
                            init_depth=d, init_normal_world=n, init_cost=c)
                new[i] = on_host(scale, out)
            maps, tag = new, tag + 1
        return maps, tag

    log(f"phase 7: the per-view two-scale chain, {n_views} views x "
        f"{n_views - 1} sources, {label[coarse]} then {label[fine]}, "
        f"PatchMatchParams(), texture scale {CHAIN_TEXTURE_SCALE}")
    # the yardstick of the 1.5x rule (and the fine shape's warm-up)
    ref_err = photometric_yardstick(scenes[fine], dev)
    cuda_ncc.reset_launch_counts()
    cuda_geom.reset_launch_counts()
    t_chain = time.perf_counter()
    tag, maps = 0, {}
    for i in range(n_views):
        key = problem_key(i, tag)
        out = solve(coarse, i, Mode(), key, f"{label[coarse]} photometric")
        out = prior_solve(coarse, i, out, key,
                          f"{label[coarse]} planar prior", False)
        maps[i] = on_host(coarse, out)
    maps, tag = geom_passes(coarse, maps, tag + 1)

    # JBU of each view's coarse geometric depth and normal to the fine
    # scale (scheduler.py:267-284, 639-659)
    fine_images = scenes[fine][0]
    init = {}
    for i in range(n_views):
        d, n, c = (torch.as_tensor(a, device=dev) for a in maps[i])
        gray = torch.as_tensor(fine_images[i], device=dev)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        up_d = jbu_depth(gray, d, params)
        up_n, _ = jbu_normal_cost(gray, n, c, params)
        b.record()
        torch.cuda.synchronize()
        jbu_name = f"jbu {label[coarse]} -> {label[fine]}"
        dev_ms.setdefault(jbu_name, []).append(a.elapsed_time(b))
        assert torch.isfinite(up_d).all() and torch.isfinite(up_n).all()
        if i == 0:
            jbu_err = scale_error(fine, up_d)
            log(f"  view 0 {jbu_name}: median interior |depth - z| "
                f"{jbu_err[0]:.5f}, share < 0.5 {jbu_err[1]:.4f}")
        init[i] = (up_d.cpu().numpy(), up_n.cpu().numpy())

    for i in range(n_views):
        key = problem_key(i, tag)
        out = solve(fine, i, Mode(hierarchy=True), key,
                    f"{label[fine]} hierarchy", init_depth=init[i][0],
                    init_normal_world=init[i][1])
        out = prior_solve(fine, i, out, key,
                          f"{label[fine]} hierarchy + planar prior", True)
        maps[i] = on_host(fine, out)
    maps, tag = geom_passes(fine, maps, tag + 1)
    t_chain = time.perf_counter() - t_chain
    zncc_counts = dict(cuda_ncc.launches)
    geom_counts = dict(cuda_geom.launches)

    log(f"  chain on {card}: {t_chain:.2f} s wall for "
        f"{sum(len(v) for k, v in dev_ms.items() if 'jbu' not in k)} solves;"
        f" host prior build {prior_s[coarse]:.2f} s ({label[coarse]}) + "
        f"{prior_s[fine]:.2f} s ({label[fine]}) over {n_views} views each; "
        f"launches zncc {zncc_counts}, geom {geom_counts}")
    for name, ms in dev_ms.items():
        # view 0 of each pass is its warm-up at that shape and mode
        rest = ms[1:]
        log(f"  {name}: device ms per solve median "
            f"{statistics.median(rest):.1f}, mean {statistics.fmean(rest):.1f}"
            f" over views 1-{len(ms) - 1} (view 0: {ms[0]:.1f})")
    assert all(v > 0 for v in zncc_counts.values()), zncc_counts
    assert all(v > 0 for v in geom_counts.values()), geom_counts

    med, share = scale_error(fine, maps[0][0])
    log(f"  view 0 final median interior |depth - z| {med:.5f} (bar "
        f"{CHAIN_MEDIAN_BAR}; {med / ref_err[0]:.3f} x the photometric "
        f"{label[fine]} solve's {ref_err[0]:.5f}, bar {CHAIN_RATIO_BAR}; "
        f"JBU'd coarse {jbu_err[0]:.5f}); share < 0.5: {share:.4f} (bar "
        f"{CHAIN_SHARE_BAR}; photometric {ref_err[1]:.4f}, JBU'd coarse "
        f"{jbu_err[1]:.4f})")
    assert med < CHAIN_MEDIAN_BAR, med
    assert share > CHAIN_SHARE_BAR, share
    assert med <= CHAIN_RATIO_BAR * ref_err[0], (med, ref_err)
    return {"geom_launches": geom_counts, "zncc_launches": zncc_counts}


class _Records(logging.Handler):
    """Keeps the port's log records of one run (stage walls, fusion
    counts, the throughput line)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def run_pipeline_phase(scene, dev, work, ref_err):
    """Phase 8: `scene` (9 views of phase 7's fine scale) written as a
    dense folder under `work` goes through run_pipeline on `dev` with
    PipelineConfig(): the scheduler resizes every view to 800x592, runs
    the two-scale schedule through the .dmb contract and fuses the final
    geometric depths to a PLY. Holds the layout, view 0's final depth
    (phase 7's bars, `ref_err` the photometric 1600x1184 solve of view 0
    with its 8 sources) and the fused cloud to their bars, and times the
    fusion's sampler launches with CUDA events; then fuses the same
    checkpoints through the plain sampler, and a prior-aware fusion with a
    x1.002 second candidate through the kernel and the plain version, and
    requires equal PLY bytes. Returns the launch counts of the pipeline
    run and of the prior-aware kernel fusion."""
    import dataclasses
    import shutil

    import torch

    from acmmp_tpu_torch.config import PipelineConfig
    from acmmp_tpu_torch.engine.fusion import (run_fusion,
                                               run_prior_aware_fusion)
    from acmmp_tpu_torch.io import read_dmb, read_ply, write_dmb
    from acmmp_tpu_torch.io.dense_folder import result_dir
    from acmmp_tpu_torch.ops import cuda_geom, cuda_ncc, cuda_sample
    from acmmp_tpu_torch.pipeline.scheduler import (generate_sample_list,
                                                    run_pipeline)
    from acmmp_tpu_torch.utils.synth import write_dense_folder

    images, cams, plane_z = scene
    n_views = len(images)
    H, W = images[0].shape
    t0 = time.perf_counter()
    dense = write_dense_folder(os.path.join(work, "dense"), images, cams)
    write_s = time.perf_counter() - t0
    cfg = PipelineConfig()
    records = _Records()
    port_log = logging.getLogger("acmmp_tpu_torch")
    port_log.addHandler(records)
    counters = {"zncc": cuda_ncc, "geom": cuda_geom, "sample": cuda_sample}
    for c in counters.values():
        c.reset_launch_counts()
    # CUDA events around each sampler launch of the run's fusion, and the
    # bytes that launch must move (sample_bytes, queued after it on the
    # stream: no host sync inside the fusion)
    launch_gather, sampler = cuda_sample.gather2d_cuda, []

    def timed_gather(maps, rr, cc, valid):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = launch_gather(maps, rr, cc, valid)
        b.record()
        sampler.append((a, b, sample_bytes(maps, rr, cc, valid)))
        return out

    cuda_sample.gather2d_cuda = timed_gather
    t0 = time.perf_counter()
    try:
        ply = run_pipeline(dense, cfg, device=dev)
    finally:
        cuda_sample.gather2d_cuda = launch_gather
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    sampler_ms = [a.elapsed_time(b) for a, b, _ in sampler]
    sampler_bound_ms = sum(n.item() for _, _, n in sampler) / (
        PEAK_BYTES_PER_S * 1e-3)
    launches = {k: dict(c.launches) for k, c in counters.items()}
    port_log.removeHandler(records)
    stages = [(r.stage, r.seconds) for r in records.records
              if hasattr(r, "stage")]
    lines = [r.getMessage() for r in records.records
             if r.getMessage().startswith(("pipeline:", "fusion:"))]
    per_view = [r.args[1] for r in records.records
                if r.msg.startswith("fusion view")]

    # the checkpoint layout and sizes (the .dmb contract, 1600x1184)
    out = os.path.dirname(ply)
    for i in range(n_views):
        rdir = result_dir(out, i)
        for name, nb in (("depths.dmb", 1), ("depths_geom.dmb", 1),
                         ("costs.dmb", 1), ("normals.dmb", 3)):
            size = os.path.getsize(os.path.join(rdir, name))
            assert size == 16 + 4 * H * W * nb, (i, name, size)
        markers = [f for f in os.listdir(rdir) if f.startswith(".pass_")]
        assert len(markers) == 6, (i, markers)

    med, share = interior_error(
        read_dmb(os.path.join(result_dir(out, 0), "depths_geom.dmb")), W, H,
        plane_z)
    pts, _, _ = read_ply(ply)
    err = np.abs(pts[:, 2] - plane_z)
    f_med, f_share = float(np.median(err)), float((err < 0.5).mean())

    # the same fusion through the plain sampler: the same bytes
    problems = generate_sample_list(dense)
    plain_fp = dataclasses.replace(cfg.fusion, sample_backend="plain")
    t0 = time.perf_counter()
    plain_ply = run_fusion(dense, out, problems, True, plain_fp,
                           ply_name="plain_sampler.ply", device=dev)
    plain_fusion_s = time.perf_counter() - t0
    with open(ply, "rb") as a, open(plain_ply, "rb") as b:
        plain_equal = a.read() == b.read()

    # prior-aware fusion: candidate 0 the run's checkpoints, candidate 1 a
    # copy whose depths are x1.002; kernel against plain
    second = os.path.join(dense, "ACMMP_x1002")
    for i in range(n_views):
        src, dst = result_dir(out, i), result_dir(second, i)
        os.makedirs(dst)
        write_dmb(os.path.join(dst, "depths_geom.dmb"),
                  read_dmb(os.path.join(src, "depths_geom.dmb")) * 1.002)
        shutil.copy(os.path.join(src, "normals.dmb"), dst)
    dual = {}
    for backend in ("auto", "plain"):
        fp = dataclasses.replace(cfg.fusion, sample_backend=backend,
                                 single_match_penalty=1)
        cuda_sample.reset_launch_counts()
        t0 = time.perf_counter()
        path = run_prior_aware_fusion(
            dense, second, out, problems, True, fp, single_match_penalty=1,
            ply_name=f"dual_{backend}.ply", device=dev)
        with open(path, "rb") as f:
            dual[backend] = (f.read(), time.perf_counter() - t0,
                             cuda_sample.launches_by_channels.get(8, 0))
    dual_pts = read_ply(os.path.join(second, "dual_auto.ply"))[0]

    log(f"  dense folder written in {write_s:.2f} s; pipeline wall "
        f"{wall:.2f} s; " + "; ".join(lines))
    log("  stage walls: " + ", ".join(f"{k} {v:.2f} s" for k, v in stages))
    log(f"  launches: {launches}")
    log(f"  fusion's sampler launches (CUDA events): "
        f"{sum(sampler_ms):.4f} ms in all over {len(sampler_ms)}, "
        f"{[round(t, 4) for t in sampler_ms]}; bound of their inputs "
        f"{sampler_bound_ms:.4f} ms (bytes), "
        f"{sampler_bound_ms / sum(sampler_ms):.3f} of it")
    log(f"  fused points per view {per_view}, {len(pts)} in all; median "
        f"|z - plane| {f_med:.6f} (bar {FUSED_MEDIAN_BAR}), share < 0.5 "
        f"{f_share:.5f} (bar {FUSED_SHARE_BAR}); plain-sampler fusion "
        f"{plain_fusion_s:.2f} s, PLY bytes equal {plain_equal}")
    log(f"  view 0 final depths_geom.dmb: median interior |depth - z| "
        f"{med:.5f} (bar {CHAIN_MEDIAN_BAR}; {med / ref_err[0]:.3f} x "
        f"the photometric 1600x1184 solve's {ref_err[0]:.5f}, bar "
        f"{CHAIN_RATIO_BAR}), share < 0.5 {share:.4f} (bar "
        f"{CHAIN_SHARE_BAR})")
    log(f"  prior-aware fusion (x1.002 second candidate): {len(dual_pts)} "
        f"points; kernel {dual['auto'][1]:.2f} s with "
        f"{dual['auto'][2]} sampler launches, plain {dual['plain'][1]:.2f} "
        f"s; PLY bytes equal {dual['auto'][0] == dual['plain'][0]}")
    assert med < CHAIN_MEDIAN_BAR, med
    assert share > CHAIN_SHARE_BAR, share
    assert med <= CHAIN_RATIO_BAR * ref_err[0], (med, ref_err)
    assert np.isfinite(pts).all()
    assert len(pts) >= FUSED_MIN_VIEW_SHARE * H * W, len(pts)
    assert f_med < FUSED_MEDIAN_BAR, f_med
    assert f_share > FUSED_SHARE_BAR, f_share
    assert plain_equal
    assert len(sampler_ms) == n_views, sampler_ms
    assert len(dual_pts) > 0 and dual["auto"][0] == dual["plain"][0]
    return {"launches": launches, "dual_launches": dual["auto"][2],
            "dense": dense, "wall": wall, "points": len(pts)}


def batch_views(images, cams, refs, params, dev, drop_last=(), depth_of=None):
    """Single-view SolverInputs of the reference views `refs` of a scene,
    each with every other view as a source; a view in `drop_last` loses
    its last source, which leaves it a padded slot. With `depth_of`
    (view index -> depth map) each carries its sources' depth maps."""
    from acmmp_tpu_torch.engine.inputs import build_solver_inputs

    n_src = len(images) - 1
    out = []
    for b in refs:
        src = [j for j in range(len(images)) if j != b]
        if b in drop_last:
            src = src[:-1]
        kw = {}
        if depth_of is not None:
            kw["src_depths"] = [depth_of(j) for j in src]
        out.append(build_solver_inputs(
            images[b], [images[j] for j in src], cams[b],
            [cams[j] for j in src], params, num_views_pad=n_src, device=dev,
            **kw))
    return out


def view_planes(inputs, K, seed):
    """K random plane fields per view ([K, H, W, 4] each; the windowed
    law with a cap), each view from its own keys."""
    from acmmp_tpu_torch.core import geometry as geo
    from acmmp_tpu_torch.ops import keys, sampling

    H, W = inputs[0].ref_img.shape
    x, y = geo.pixel_grid(H, W, device=inputs[0].ref_img.device)
    return [torch_stack([sampling.random_plane(
        k, inp.ref_cam, x, y, inp.depth_min, inp.depth_max,
        tile_window=0.125, min_cos=0.25)
        for k in keys.split(keys.key(seed + b), K)])
        for b, inp in enumerate(inputs)]


def torch_stack(ts, dim=0):
    import torch

    return torch.stack(ts, dim).contiguous()


def zncc_bar(got, ref):
    """(share of costs beyond the ZNCC bar, max |d|) of `got` against
    `ref`."""
    d = (got - ref).abs()
    bad = (d > ZNCC_ATOL + ZNCC_RTOL * ref.abs()).float().mean().item()
    return bad, d.max().item()


def run_batched_kernels_phase(dev):
    """Phase 3f: each kernel's batched launch against the same views'
    single-view launches (torch.equal) and against its batched plain
    version (the single-view checks' bars: the ZNCC bar, geom bitwise),
    B = 3 reference views of the plane scene at 320x240 / 4 sources and
    1600x1184 / 8 sources, view 1 with a padded source slot: zncc.cu K=1
    on the full grid and K=8, 3 and 2 packed at both parities on 8-bit
    and float sources, geom.cu K=1 on the full grid and K=8 and 5 packed
    at both parities. One launch per batch. Returns the largest |d| of
    each batched kernel against its plain version at 1600x1184, by
    (kind, K)."""
    import torch

    from acmmp_tpu_torch.config import PatchMatchParams
    from acmmp_tpu_torch.ops import cuda_geom, cuda_ncc
    from acmmp_tpu_torch.ops import geom as geom_ops
    from acmmp_tpu_torch.ops import ncc as ncc_ops
    from acmmp_tpu_torch.ops import parity
    from acmmp_tpu_torch.parallel.sharding import stack_solver_inputs
    from acmmp_tpu_torch.utils.synth import textured_plane_scene

    errs = {}
    params = PatchMatchParams()
    for width, height, n_src in ((320, 240, 4), (1600, 1184, 8)):
        images, cams, pz = textured_plane_scene(
            n_views=n_src + 1, width=width, height=height,
            f=600.0 * width / 320.0, plane_z=5.0)
        Hs, Ws = images[0].shape
        gy = np.linspace(0.0, 0.3, Hs, dtype=np.float32)[:, None]

        def depth_of(j):
            return np.broadcast_to(pz + (gy if j % 2 else -gy),
                                   (Hs, Ws)).astype(np.float32)

        for kparams in (params, dataclasses.replace(params,
                                                    ncc_src_u8=False)):
            kind = cuda_ncc.source_type(kparams)
            pparams = dataclasses.replace(kparams, ncc_backend="plain")
            views = batch_views(images, cams, (0, 1, 2), kparams, dev,
                                drop_last=(1,), depth_of=depth_of)
            nv = [int(v.view_mask.sum()) for v in views]
            assert nv == [n_src, n_src - 1, n_src], nv
            batch = stack_solver_inputs(views)
            vg_b = ncc_ops.make_view_geometry(batch.ref_cam, batch.src_cams)
            vgs = [ncc_ops.make_view_geometry(v.ref_cam, v.src_cams)
                   for v in views]
            line = []
            for K, off0 in ((1, None), (8, 0), (8, 1), (3, 0), (3, 1),
                            (2, 0), (2, 1)):
                planes = view_planes(views, K, 300 + 10 * K)
                if off0 is not None:
                    planes = [parity.pack_rows_c(p, off0).contiguous()
                              for p in planes]
                stack = torch_stack(planes, 1)

                def run(p, ref, src, vg, hyps, n):
                    if off0 is None:
                        return ncc_ops.multiview_zncc(ref, src, vg, hyps, p,
                                                      n_views=n)
                    return ncc_ops.multiview_zncc_packed(
                        ref, src, vg, hyps, p, off0, n_views=n)

                before = cuda_ncc.total_launches()
                got = run(kparams, batch.ref_img, batch.src_imgs, vg_b,
                          stack, nv)
                assert cuda_ncc.total_launches() == before + 1
                singles = [run(kparams, v.ref_img, v.src_imgs, vgs[b],
                               planes[b], nv[b])
                           for b, v in enumerate(views)]
                ref = run(pparams, batch.ref_img, batch.src_imgs, vg_b,
                          stack, nv)
                torch.cuda.synchronize()
                equal = all(torch.equal(got[:, b], s)
                            for b, s in enumerate(singles))
                bars = [zncc_bar(got[:, b, ..., :n], ref[:, b, ..., :n])
                        for b, n in enumerate(nv)]
                bad = max(b_ for b_, _ in bars)
                err = max(e for _, e in bars)
                pad = bool((got[:, 1, ..., nv[1]:] == kparams.cost_max).all())
                if width == 1600:
                    errs[(kind, K)] = max(errs.get((kind, K), 0.0), err)
                line.append(f"K={K} off0={off0}: == singles {equal}, vs "
                            f"plain bad {bad:.2e} max|d| {err:.2e}")
                assert equal, (width, kind, K, off0)
                assert bad < ZNCC_MAX_FRAC, (width, kind, K, off0, bad)
                assert pad, (width, kind, K, off0)
            log(f"phase 3f: batched zncc.cu, {width}x{height}, B=3 (view 1 "
                f"{nv[1]} of {n_src} sources), {kind} sources: "
                + "; ".join(line))
            if kind != "u8":
                continue
            line = []
            for K, off0 in ((1, None), (8, 0), (8, 1), (5, 0), (5, 1)):
                planes = view_planes(views, K, 400 + 10 * K)
                if off0 is not None:
                    planes = [parity.pack_rows_c(p, off0).contiguous()
                              for p in planes]
                args = (batch.ref_cam, batch.src_cams, batch.src_depths,
                        torch_stack(planes, 1))
                before = cuda_geom.total_launches()
                got = geom_ops.geom_consistency_cost(
                    *args, params, row_pack_off=off0, n_views=nv)
                assert cuda_geom.total_launches() == before + 1
                singles = [geom_ops.geom_consistency_cost(
                    v.ref_cam, v.src_cams, v.src_depths, planes[b], params,
                    row_pack_off=off0, n_views=nv[b])
                    for b, v in enumerate(views)]
                ref = geom_ops.geom_consistency_cost(
                    *args, pparams, row_pack_off=off0)
                torch.cuda.synchronize()
                equal = all(torch.equal(got[:, b], s)
                            for b, s in enumerate(singles))
                eq_plain = bool(torch.equal(got, ref))
                if width == 1600:
                    errs[("geom", K)] = max(
                        errs.get(("geom", K), 0.0),
                        (got - ref).abs().max().item())
                line.append(f"K={K} off0={off0}: == singles {equal}, == "
                            f"plain {eq_plain}")
                assert equal and eq_plain, (width, K, off0)
            log(f"phase 3f: batched geom.cu, {width}x{height}, B=3: "
                + "; ".join(line))
            del views, batch, got, ref, singles
    return errs


def profile_solve(fn):
    """(traced wall ms, device-busy ms, device ops, idle share) of one
    call of `fn` under torch.profiler (CPU and CUDA activity), as
    tools/torch_solve_profile.py reads them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
               for e in events) / 1e3
    return (wall_ms, busy, sum(e.count for e in events),
            max(0.0, 1.0 - busy / wall_ms))


def run_batched_solve_phase(scenes, dev):
    """Phase 5c: the batched photometric solve at full width. Reference
    views 0-3 of phase 8's 9-view scene, each with the 8 others as
    sources, in one BatchedSolver.solve_batch (B = 4), at 1600x1184 and
    at 800x592 (the pipeline's coarse scale): 13 ZNCC launches for the
    batch (counted from 0 around it); each view torch.equal to its own
    run_patchmatch with the same key; each view's median interior error
    under 0.15; then, after a warm-up, the batch and the same four views
    solved one by one, timed in turns (one by one, batch, batch, one by
    one; host clock to a synchronize, and CUDA events), and one batched
    and one single solve under torch.profiler. At 1600x1184 the batched
    kernels are also timed per launch (B = 4) beside their batched plain
    versions. Returns the per-launch table of the batched kernels and
    the launches of the checked batched solve."""
    import torch

    from acmmp_tpu_torch.config import PatchMatchParams
    from acmmp_tpu_torch.engine.patchmatch import Mode, run_patchmatch
    from acmmp_tpu_torch.ops import cuda_geom, cuda_ncc, keys
    from acmmp_tpu_torch.pipeline.batched import BatchedSolver

    params = PatchMatchParams()
    solver = BatchedSolver(params)
    refs = (0, 1, 2, 3)
    ks = [keys.key(500 + b) for b in refs]
    table, launched = {}, None
    for label in ("1600x1184", "800x592"):
        images, cams, pz = scenes[label]
        H, W = images[0].shape
        views = batch_views(images, cams, refs, params, dev)

        def batched():
            return solver.solve_batch(views, ks, Mode())

        def one_by_one():
            return [run_patchmatch(v, k, params, Mode())
                    for v, k in zip(views, ks)]

        batched()
        one_by_one()
        torch.cuda.synchronize()
        cuda_ncc.reset_launch_counts()
        cuda_geom.reset_launch_counts()
        outs = batched()
        torch.cuda.synchronize()
        counts = dict(cuda_ncc.launches)
        assert sum(cuda_ncc.launches_f32.values()) == 0
        assert cuda_geom.total_launches() == 0
        singles = one_by_one()
        torch.cuda.synchronize()
        equal = [all(torch.equal(getattr(o, f), getattr(s, f))
                     for f in o._fields) for o, s in zip(outs, singles)]
        errs = [interior_error(o.depth[:H, :W], W, H, pz)[0] for o in outs]
        n_sweeps = 2 * params.max_iterations
        want = {1: 1, 8: n_sweeps, 3: n_sweeps, 2: n_sweeps}
        log(f"phase 5c: {label}, views {refs} x 8 sources, one "
            f"solve_batch: launches {counts} (want {want}); each view == "
            f"its run_patchmatch {equal}; median interior |depth - z| "
            f"{[round(e, 5) for e in errs]} (bar 0.15)")
        assert counts == want, counts
        assert all(equal), equal
        assert all(e < 0.15 for e in errs), errs
        if launched is None:
            launched = counts
        del outs, singles

        def timed(fn):
            ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
            torch.cuda.synchronize()
            ev0.record()
            t0 = time.perf_counter()
            fn()
            ev1.record()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3, ev0.elapsed_time(ev1)

        turns = [("one by one", one_by_one), ("batch", batched),
                 ("batch", batched), ("one by one", one_by_one)]
        walls = {}
        for name, fn in turns:
            walls.setdefault(name, []).append(timed(fn))
        prof_b = profile_solve(batched)
        prof_1 = profile_solve(lambda: run_patchmatch(views[0], ks[0],
                                                      params, Mode()))
        b_ms = [w for w, _ in walls["batch"]]
        s_ms = [w / len(refs) for w, _ in walls["one by one"]]
        log(f"  {label}: batch of {len(refs)} {walls['batch']} ms (host, "
            f"CUDA events), {[round(w / len(refs), 2) for w in b_ms]} ms "
            f"per view; one by one {walls['one by one']} ms, "
            f"{[round(w, 2) for w in s_ms]} ms per view; per-view ratio "
            f"batch / one by one {min(b_ms) / len(refs) / min(s_ms):.4f}")
        for name, (wall, busy, n_ops, idle) in (("batch", prof_b),
                                                 ("single", prof_1)):
            log(f"  {label}: profiled {name} solve: wall {wall:.1f} ms "
                f"(traced), device busy {busy:.1f} ms over {n_ops} device "
                f"ops, idle share {idle:.3f}")
        if label == "1600x1184":
            table = time_batched_kernels(views, pz, dev)
        del views
    return table, launched


def time_batched_kernels(views, pz, dev):
    """Per-launch times of the batched kernels at B = len(views) on the
    main path's shapes (1600x1184 / 8 sources): zncc.cu K=1 full grid
    and K=8/3/2 packed, geom.cu K=1 and K=8/5 packed (on depth maps of
    the plane), each beside its batched plain version and its bound
    (B times the single-view bound). Returns {(kernel, K): (ms, plain ms,
    bound ms, bound by)}."""
    import torch

    from acmmp_tpu_torch.config import PatchMatchParams
    from acmmp_tpu_torch.ops import cuda_geom, cuda_ncc
    from acmmp_tpu_torch.ops import geom as geom_ops
    from acmmp_tpu_torch.ops import ncc as ncc_ops
    from acmmp_tpu_torch.ops import parity
    from acmmp_tpu_torch.parallel.sharding import stack_solver_inputs

    params = PatchMatchParams()
    pparams = PatchMatchParams(ncc_backend="plain")
    B = len(views)
    batch = stack_solver_inputs(views)
    _, H, W = batch.ref_img.shape
    V, Hs, Ws = batch.src_imgs.shape[1:]
    nv = batch.view_mask.sum(-1).tolist()
    vg = ncc_ops.make_view_geometry(batch.ref_cam, batch.src_cams)
    preps = {None: cuda_ncc.prepare(batch.ref_img, batch.src_imgs, vg,
                                    params, None)}
    preps[0] = cuda_ncc.prepare(batch.ref_img, batch.src_imgs, vg, params, 0,
                                shared=preps[None])
    T = len(params.tap_offsets) ** 2
    table = {}
    for K in (1, 8, 3, 2):
        off0 = None if K == 1 else 0
        Hg = H if off0 is None else H // 2
        planes = view_planes(views, K, 600 + K)
        if off0 is not None:
            planes = [parity.pack_rows_c(p, off0) for p in planes]
        stack = torch_stack(planes, 1)

        def kern():
            return cuda_ncc.multiview_zncc_cuda(
                batch.ref_img, batch.src_imgs, vg, stack, params,
                row_pack_off=off0, n_views=nv, prep=preps[off0])

        def plain():
            if off0 is None:
                return ncc_ops.multiview_zncc(batch.ref_img, batch.src_imgs,
                                              vg, stack, pparams)
            return ncc_ops.multiview_zncc_packed(
                batch.ref_img, batch.src_imgs, vg, stack, pparams, off0)

        ms = time_ms(kern, 10)
        plain_ms = time_ms(plain, 1)
        evals = K * sum(nv) * T * Hg * W
        nbytes = (K * B * Hg * W * 16 + sum(nv) * Hs * Ws
                  + B * (2 * T + 3) * Hg * W * 4 + K * B * Hg * W * V * 4)
        t_ops = evals * OPS_PER_TAP_EVAL / PEAK_FP32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        b_ms = max(t_ops, t_bytes)
        b_by = "operations" if t_ops >= t_bytes else "bytes"
        table[("zncc", K)] = (ms, plain_ms, b_ms, b_by)
        log(f"  batched zncc.cu K={K}, B={B}, grid {Hg}x{W}: {ms:.4f} ms "
            f"per launch, {ms / B:.4f} ms per view; plain {plain_ms:.3f} "
            f"ms; bound {b_ms:.4f} ms ({b_by})")
    del preps
    gviews = [v._replace(src_depths=torch.full((V, Hs, Ws), pz,
                                               device=dev)) for v in views]
    gbatch = stack_solver_inputs(gviews)
    gprep = cuda_geom.prepare(gbatch.ref_cam, gbatch.src_cams,
                              gbatch.src_depths)
    for K in (1, 8, 5):
        off0 = None if K == 1 else 0
        Hg = H if off0 is None else H // 2
        planes = view_planes(views, K, 700 + K)
        if off0 is not None:
            planes = [parity.pack_rows_c(p, off0) for p in planes]
        args = (gbatch.ref_cam, gbatch.src_cams, gbatch.src_depths,
                torch_stack(planes, 1))

        def gkern():
            return cuda_geom.geom_consistency_cost_cuda(
                *args, params, row_pack_off=off0, n_views=nv, prep=gprep)

        def gplain():
            return geom_ops.geom_consistency_cost(*args, pparams,
                                                  row_pack_off=off0)

        ms = time_ms(gkern, 20)
        plain_ms = time_ms(gplain, 2)
        ops = ((K * GEOM_OPS_PER_EVAL + GEOM_OPS_PER_PIXEL_VIEW)
               * sum(nv) * Hg * W)
        nbytes = (K * B * Hg * W * 16 + sum(nv) * Hs * Ws * 4
                  + K * B * Hg * W * V * 4)
        t_ops = ops / PEAK_FP32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        b_ms = max(t_ops, t_bytes)
        b_by = "operations" if t_ops >= t_bytes else "bytes"
        table[("geom", K)] = (ms, plain_ms, b_ms, b_by)
        log(f"  batched geom.cu K={K}, B={B}, grid {Hg}x{W}: {ms:.4f} ms "
            f"per launch, {ms / B:.4f} ms per view; plain {plain_ms:.3f} "
            f"ms; bound {b_ms:.4f} ms ({b_by})")
    return table


def run_batched_pipeline_phase(dense, scene, dev, phase8):
    """Phase 8b: a dense folder of the first PHASE8B_VIEWS views of phase
    8's scene through run_pipeline with PipelineConfig(view_batch=4):
    the batched executor solves each pass's views in batches of 4 and 1.
    Launch counts from 0 around the run (each batch issues one solve's
    launches), the stage walls and solves/s, the .dmb layout, and the
    fused cloud at phase 8's bars. The PLY need not equal phase 8's: a
    batch reads its batch-mates' maps of the previous pass in the
    multi_geometry pass, where the one-view path reads this pass's."""
    import torch

    from acmmp_tpu_torch.config import PipelineConfig
    from acmmp_tpu_torch.io import read_dmb, read_ply
    from acmmp_tpu_torch.io.dense_folder import result_dir
    from acmmp_tpu_torch.ops import cuda_geom, cuda_ncc, cuda_sample
    from acmmp_tpu_torch.pipeline.scheduler import run_pipeline

    images, cams, plane_z = scene
    n_views = len(images)
    H, W = images[0].shape
    B = 4
    cfg = PipelineConfig(view_batch=B, output_dir="ACMMP_B4")
    records = _Records()
    port_log = logging.getLogger("acmmp_tpu_torch")
    port_log.addHandler(records)
    counters = {"zncc": cuda_ncc, "geom": cuda_geom, "sample": cuda_sample}
    for c in counters.values():
        c.reset_launch_counts()
    t0 = time.perf_counter()
    ply = run_pipeline(dense, cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: dict(c.launches) for k, c in counters.items()}
    port_log.removeHandler(records)
    stages = [(r.stage, r.seconds) for r in records.records
              if hasattr(r, "stage")]
    lines = [r.getMessage() for r in records.records
             if r.getMessage().startswith(("pipeline:", "fusion:"))]

    out = os.path.dirname(ply)
    assert os.path.basename(out) == "ACMMP_B4", out
    for i in range(n_views):
        rdir = result_dir(out, i)
        for name, nb in (("depths.dmb", 1), ("depths_geom.dmb", 1),
                         ("costs.dmb", 1), ("normals.dmb", 3)):
            size = os.path.getsize(os.path.join(rdir, name))
            assert size == 16 + 4 * H * W * nb, (i, name, size)
        markers = [f for f in os.listdir(rdir) if f.startswith(".pass_")]
        assert len(markers) == 6, (i, markers)
    med, share = interior_error(
        read_dmb(os.path.join(result_dir(out, 0), "depths_geom.dmb")), W, H,
        plane_z)
    pts, _, _ = read_ply(ply)
    err = np.abs(pts[:, 2] - plane_z)
    f_med, f_share = float(np.median(err)), float((err < 0.5).mean())
    # per pass ceil(9 / 4) batches, each one solve's launches; per view
    # and scale a first solve, its planar-prior second solve and two
    # geometric solves
    n_sweeps = 2 * cfg.patchmatch.max_iterations
    n_batches = -(-n_views // B)
    solves, geom_solves = 8 * n_batches, 4 * n_batches
    want = {"zncc": {1: solves, 8: solves * n_sweeps, 3: solves * n_sweeps,
                     2: solves * n_sweeps},
            "geom": {1: geom_solves, 8: geom_solves * n_sweeps,
                     5: geom_solves * n_sweeps},
            "sample": {"gather2d": n_views}}
    ratio = {k: sum(launches[k].values())
             / max(sum(phase8["launches"][k].values()), 1)
             for k in ("zncc", "geom")}
    log(f"  pipeline wall {wall:.2f} s (phase 8 {phase8['wall']:.2f} s); "
        + "; ".join(lines))
    log("  stage walls: " + ", ".join(f"{k} {v:.2f} s" for k, v in stages))
    log(f"  launches: {launches} (want {want}); against phase 8's: zncc "
        f"{ratio['zncc']:.4f}, geom {ratio['geom']:.4f}")
    log(f"  fused points {len(pts)} (phase 8: {phase8['points']}); median "
        f"|z - plane| {f_med:.6f} (bar {FUSED_MEDIAN_BAR}), share < 0.5 "
        f"{f_share:.5f} (bar {FUSED_SHARE_BAR}); view 0 final depth median "
        f"interior error {med:.5f}, share < 0.5 {share:.4f}")
    assert launches == want, (launches, want)
    assert np.isfinite(pts).all()
    assert len(pts) >= FUSED_MIN_VIEW_SHARE * H * W, len(pts)
    assert f_med < FUSED_MEDIAN_BAR, f_med
    assert f_share > FUSED_SHARE_BAR, f_share
    return {"launches": launches, "wall": wall, "points": len(pts)}


def run_tile_phase(dev):
    """Phase 11b: a 3200x2368 / 8-source textured-plane view, above
    tile_pixels, solved with its rows over a tile mesh of MESH_MEMBERS
    members on one card (parallel/tiles.py), photometric and then
    geometric (source depths the true plane's, re-entry from the tiled
    photometric solve): each torch.equal to the untiled run_patchmatch on
    depth, normal, cost and pre_costs, 13 ZNCC launches per member (9 geom
    in the geometric mode) with the counts set to 0 just before, median
    interior error under 0.15; walls of both printed. Returns the
    launches and walls."""
    import torch

    from acmmp_tpu_torch.config import PatchMatchParams, PipelineConfig
    from acmmp_tpu_torch.engine.inputs import build_solver_inputs
    from acmmp_tpu_torch.engine.patchmatch import Mode, run_patchmatch
    from acmmp_tpu_torch.ops import cuda_geom, cuda_ncc, keys
    from acmmp_tpu_torch.parallel.tiles import (HALO, make_tile_mesh,
                                                tile_sharded_patchmatch)
    from acmmp_tpu_torch.utils.synth import textured_plane_scene

    width, height, n_src = TILE_SHAPE
    assert width * height > PipelineConfig().tile_pixels
    t0 = time.perf_counter()
    images, cams, plane_z = textured_plane_scene(
        n_views=n_src + 1, width=width, height=height,
        f=600.0 * width / 320.0, plane_z=5.0)
    scene_s = time.perf_counter() - t0
    params = PatchMatchParams()
    mesh = make_tile_mesh(devices=[dev] * MESH_MEMBERS)
    photo = build_solver_inputs(images[0], images[1:], cams[0], cams[1:],
                                params, device=dev)
    H, W = photo.ref_img.shape
    assert (H, W) == (height, width)
    assert H % (8 * MESH_MEMBERS) == 0 and H // MESH_MEMBERS >= HALO
    log(f"  scene built in {scene_s:.2f} s; {MESH_MEMBERS} members of "
        f"{H // MESH_MEMBERS} rows (+{HALO}-row halos)")
    n_sweeps = 2 * params.max_iterations
    result = {"launches": {}, "walls": {}}

    def solve(label, inputs, mode, key):
        torch.cuda.synchronize()
        cuda_ncc.reset_launch_counts()
        cuda_geom.reset_launch_counts()
        t = time.perf_counter()
        tiled = tile_sharded_patchmatch(mesh, inputs, key, params, mode)
        torch.cuda.synchronize()
        t_tiled = time.perf_counter() - t
        counts = {"zncc": dict(cuda_ncc.launches),
                  "geom": dict(cuda_geom.launches)}
        t = time.perf_counter()
        whole = run_patchmatch(inputs, key, params, mode)
        torch.cuda.synchronize()
        t_whole = time.perf_counter() - t
        equal = {f: bool(torch.equal(getattr(tiled, f), getattr(whole, f)))
                 for f in tiled._fields}
        med, share = interior_error(tiled.depth, W, H, plane_z)
        n = MESH_MEMBERS
        want = {"zncc": {1: n, 8: n * n_sweeps, 3: n * n_sweeps,
                         2: n * n_sweeps},
                "geom": ({1: n, 8: n * n_sweeps, 5: n * n_sweeps}
                         if mode.geom_consistency else {1: 0, 8: 0, 5: 0})}
        log(f"  {label}: tiled {t_tiled:.3f} s, untiled {t_whole:.3f} s "
            f"(host clock, synchronized); torch.equal {equal}; launches "
            f"{counts} (want {want}); median interior |depth - z| "
            f"{med:.5f} (bar 0.15), share < 0.5 {share:.4f}")
        assert all(equal.values()), (label, equal)
        assert counts == want, (label, counts, want)
        assert med < 0.15, (label, med)
        result["launches"][label] = counts
        result["walls"][label] = (t_tiled, t_whole)
        return tiled

    out = solve("photometric", photo, Mode(), keys.key(11))
    geo_in = build_solver_inputs(
        images[0], images[1:], cams[0], cams[1:], params, device=dev,
        src_depths=[np.full(im.shape, plane_z, np.float32)
                    for im in images[1:]],
        init_depth=out.depth.cpu().numpy(),
        init_normal_world=out.normal_world.cpu().numpy())
    solve("geometric", geo_in, Mode(geom_consistency=True), keys.key(12))
    return result


def run_mesh_pipeline_phase(dense, scene, dev, phase8):
    """Phase 11c: phase 8's dense folder through run_pipeline on a view
    mesh of MESH_MEMBERS members on one card, into a fresh output
    directory, the planar-prior second solve at the coarse scale only
    (PHASE11C_PRIOR_MAX_PIXELS): each pass's views in batches of
    MESH_MEMBERS (4, 4, 1), each batch padded to the mesh and one view
    per member; launch counts
    from 0 around the run; the geometric passes' source maps from the
    bank, so that no source .dmb is read (each view's own depth files are
    read 5 times in the run, counted); the cloud at phase 8's bars; and
    the sequential fusion of the same checkpoints writes the mesh
    fusion's PLY bytes."""
    import torch

    from acmmp_tpu_torch.config import PipelineConfig
    from acmmp_tpu_torch.engine.fusion import run_fusion
    from acmmp_tpu_torch.io import read_ply
    from acmmp_tpu_torch.ops import cuda_geom, cuda_ncc, cuda_sample
    from acmmp_tpu_torch.parallel import make_view_mesh
    from acmmp_tpu_torch.pipeline import scheduler

    images, cams, plane_z = scene
    n_views = len(images)
    H, W = images[0].shape
    cfg = PipelineConfig(output_dir="ACMMP_MESH",
                         planar_prior_max_pixels=PHASE11C_PRIOR_MAX_PIXELS)
    assert (W // 2) * (H // 2) <= PHASE11C_PRIOR_MAX_PIXELS < W * H
    mesh = make_view_mesh(devices=[dev] * MESH_MEMBERS)
    counters = {"zncc": cuda_ncc, "geom": cuda_geom, "sample": cuda_sample}
    reads = []
    real_read = scheduler.read_dmb

    def counting_read(path):
        reads.append(path)
        return real_read(path)

    records = _Records()
    port_log = logging.getLogger("acmmp_tpu_torch")
    port_log.addHandler(records)
    for c in counters.values():
        c.reset_launch_counts()
    scheduler.read_dmb = counting_read
    t0 = time.perf_counter()
    try:
        ply = scheduler.run_pipeline(dense, cfg, mesh=mesh)
    finally:
        scheduler.read_dmb = real_read
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: dict(c.launches) for k, c in counters.items()}
    port_log.removeHandler(records)
    stages = [(r.stage, r.seconds) for r in records.records
              if hasattr(r, "stage")]

    # per pass: batches of the mesh size, each padded to it, one solve
    # per member; per view and scale a first solve and two geometric
    # solves, and at the coarse scale the planar-prior second solve
    n_sweeps = 2 * cfg.patchmatch.max_iterations
    per_pass = -(-n_views // MESH_MEMBERS) * MESH_MEMBERS
    solves, geom_solves = 7 * per_pass, 4 * per_pass
    want = {"zncc": {1: solves, 8: solves * n_sweeps, 3: solves * n_sweeps,
                     2: solves * n_sweeps},
            "geom": {1: geom_solves, 8: geom_solves * n_sweeps,
                     5: geom_solves * n_sweeps},
            "sample": {"gather2d": n_views}}
    # each view's own depth files: per scale its re-entry depth and its
    # bank slot in each geometric pass (2 + 2), plus the hierarchy's
    # re-entry (depths.dmb) and JBU's input (depths_geom.dmb) once; a run
    # that read every problem's sources would add 8 reads per pass
    depth_reads = {}
    for path in reads:
        if os.path.basename(path) in ("depths.dmb", "depths_geom.dmb"):
            depth_reads[path] = depth_reads.get(path, 0) + 1
    pts, _, _ = read_ply(ply)
    err = np.abs(pts[:, 2] - plane_z)
    f_med, f_share = float(np.median(err)), float((err < 0.5).mean())
    out = os.path.dirname(ply)
    t0 = time.perf_counter()
    seq_ply = run_fusion(dense, out, scheduler.generate_sample_list(dense),
                         True, cfg.fusion, ply_name="sequential.ply",
                         device=dev)
    seq_s = time.perf_counter() - t0
    with open(ply, "rb") as a, open(seq_ply, "rb") as b:
        ply_equal = a.read() == b.read()
    fusion_s = dict(stages).get("fusion", float("nan"))
    log(f"  pipeline wall {wall:.2f} s (phase 8 {phase8['wall']:.2f} s); "
        f"{MESH_MEMBERS} members on {dev}")
    log("  stage walls: " + ", ".join(f"{k} {v:.2f} s" for k, v in stages))
    log(f"  launches: {launches} (want {want})")
    log(f"  depth-file reads per view file: {sorted(set(depth_reads.values()))}"
        f" over {len(depth_reads)} files (want 5 each; 21 with per-problem "
        f"source reads)")
    log(f"  fused points {len(pts)} (phase 8: {phase8['points']}); median "
        f"|z - plane| {f_med:.6f} (bar {FUSED_MEDIAN_BAR}), share < 0.5 "
        f"{f_share:.5f} (bar {FUSED_SHARE_BAR}); mesh fusion "
        f"{fusion_s:.2f} s, sequential {seq_s:.2f} s, PLY bytes equal "
        f"{ply_equal}")
    assert launches == want, (launches, want)
    assert len(depth_reads) == 2 * n_views, sorted(depth_reads)
    assert set(depth_reads.values()) == {5}, depth_reads
    assert np.isfinite(pts).all()
    assert len(pts) >= FUSED_MIN_VIEW_SHARE * H * W, len(pts)
    assert f_med < FUSED_MEDIAN_BAR, f_med
    assert f_share > FUSED_SHARE_BAR, f_share
    assert ply_equal
    return {"launches": launches, "wall": wall, "points": len(pts)}


def run_multiprocess_phase(dense_b, scene, dev, phase8):
    """Phase 12: two processes on this card through the product surface.
    Two copies of phase 8b's dense folder (its images, cams and pair.txt):
    on one, `python -m acmmp_tpu_torch.cli reconstruct --mesh` runs as
    PHASE12_RANKS processes under the torchrun variables (a free
    localhost port, LOCAL_WORLD_SIZE = PHASE12_RANKS: more processes than
    cards, so each owns cuda:0 and the global mesh has one member a
    process); on the other run_pipeline runs in this process over the
    single-process mesh of `dev` repeated PHASE12_RANKS times, with the
    CLI's config (PHASE11C_PRIOR_MAX_PIXELS). Every output file must be
    byte-equal, rank 1 must have written nothing, each rank's zncc.cu
    launches 13 per solve of its own member, and the cloud meets phase
    8's bars. Each rank logs its rank, the files it wrote and its launches
    (run_pipeline's last line), read here from its output."""
    import re
    import socket

    import torch

    from acmmp_tpu_torch.config import PipelineConfig
    from acmmp_tpu_torch.io import read_ply
    from acmmp_tpu_torch.ops import cuda_geom, cuda_ncc, cuda_sample
    from acmmp_tpu_torch.parallel import make_view_mesh, multihost
    from acmmp_tpu_torch.pipeline import scheduler

    images, _cams, plane_z = scene
    n_views = len(images)
    H, W = images[0].shape
    work = os.path.dirname(dense_b)
    dense = {}
    for k in ("two", "one"):
        dense[k] = os.path.join(work, f"dense_12_{k}")
        os.makedirs(dense[k])
        for name in ("images", "cams"):
            shutil.copytree(os.path.join(dense_b, name),
                            os.path.join(dense[k], name))
        shutil.copy(os.path.join(dense_b, "pair.txt"), dense[k])
    argv = ["reconstruct", dense["two"], "--mesh",
            "--planar_prior_max_pixels", str(PHASE11C_PRIOR_MAX_PIXELS)]
    repo = str(pathlib.Path(__file__).resolve().parent)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    procs = []
    t0 = time.perf_counter()
    for r in range(PHASE12_RANKS):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   RANK=str(r), WORLD_SIZE=str(PHASE12_RANKS),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(PHASE12_RANKS),
                   PYTHONPATH=repo)
        out = open(os.path.join(work, f"rank{r}.log"), "w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "acmmp_tpu_torch.cli", *argv], cwd=repo,
            env=env, stdout=out, stderr=subprocess.STDOUT), out))
    ends = [None] * PHASE12_RANKS
    try:
        while None in ends:
            for r, (p, _) in enumerate(procs):
                if ends[r] is None and p.poll() is not None:
                    ends[r] = time.perf_counter()
            if time.perf_counter() - t0 > PHASE12_TIMEOUT_S:
                raise RuntimeError(f"phase 12: a rank still runs after "
                                   f"{PHASE12_TIMEOUT_S} s")
            time.sleep(0.05)
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    two_wall = max(ends) - t0
    texts = []
    for r, (p, out) in enumerate(procs):
        out.seek(0)
        texts.append(out.read())
        out.close()
        if p.returncode != 0:
            log(texts[r][-6000:])
            raise RuntimeError(f"phase 12: rank {r} exited {p.returncode}")

    # the yardstick: the CLI's config, a single-process mesh of the same
    # members, in this process
    cfg = PipelineConfig(planar_prior_max_pixels=PHASE11C_PRIOR_MAX_PIXELS)
    counters = {"zncc": cuda_ncc, "geom": cuda_geom, "sample": cuda_sample}
    for c in counters.values():
        c.reset_launch_counts()
    written = multihost.files_written
    t1 = time.perf_counter()
    mesh = make_view_mesh(devices=[dev] * PHASE12_RANKS)
    ply = scheduler.run_pipeline(dense["one"], cfg, mesh=mesh)
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t1
    written = multihost.files_written - written
    one_launches = {k: c.total_launches() for k, c in counters.items()}

    pattern = re.compile(r"rank (\d+) of (\d+): (\d+) files written; "
                         r"launches zncc (\d+), geom (\d+), sample (\d+)")
    ranks = []
    for r, text in enumerate(texts):
        found = pattern.findall(text)
        assert len(found) == 1, (r, text[-3000:])
        rank, world, files, zncc, geom, sample = map(int, found[0])
        pipe_s = re.findall(r"pipeline: \d+ solves in ([\d.]+)s", text)
        ranks.append({"rank": rank, "world": world, "files": files,
                      "zncc": zncc, "geom": geom, "sample": sample,
                      "wall": ends[r] - t0, "pipeline_s": pipe_s})
    trees = {}
    for k in ("two", "one"):
        root = os.path.join(dense[k], "ACMMP")
        trees[k] = {}
        for d, _, files in os.walk(root):
            for f in files:
                with open(os.path.join(d, f), "rb") as fh:
                    trees[k][os.path.relpath(os.path.join(d, f), root)] = \
                        fh.read()
    differ = sorted(k for k in set(trees["two"]) | set(trees["one"])
                    if trees["two"].get(k) != trees["one"].get(k))
    n_dmb = sum(k.endswith(".dmb") for k in trees["one"])
    n_marks = sum(".pass_" in k for k in trees["one"])
    # per pass ceil(n / 2) batches of two, one problem per member each;
    # per batch a first solve and two geometric solves at each scale and
    # the coarse scale's planar-prior second solve (phase 11c's count)
    batches = -(-n_views // PHASE12_RANKS)
    solves, geom_solves = 7 * batches, 4 * batches
    n_sweeps = 2 * cfg.patchmatch.max_iterations
    want_zncc = solves * (1 + 3 * n_sweeps)
    want_geom = geom_solves * (1 + 2 * n_sweeps)
    pts, _, _ = read_ply(ply)
    err = np.abs(pts[:, 2] - plane_z)
    f_med, f_share = float(np.median(err)), float((err < 0.5).mean())
    log(f"  {PHASE12_RANKS} processes on {dev}, one member each: wall "
        f"{two_wall:.2f} s (ranks: "
        + ", ".join(f"rank {x['rank']} {x['wall']:.2f} s, pipeline "
                    f"{x['pipeline_s']} s" for x in ranks)
        + f"); single-process mesh of {PHASE12_RANKS} members in this "
        f"process {one_wall:.2f} s; phase 8 {phase8['wall']:.2f} s")
    log("  ranks: " + "; ".join(
        f"rank {x['rank']} of {x['world']}: {x['files']} files written, "
        f"launches zncc {x['zncc']} geom {x['geom']} sample {x['sample']}"
        for x in ranks)
        + f" (want zncc {want_zncc}, geom {want_geom} each); single "
        f"process: {written} files written, launches {one_launches}")
    log(f"  files: {len(trees['one'])} ({n_dmb} .dmb, {n_marks} markers, "
        f"PLY), byte-equal: {not differ}; fused points {len(pts)} "
        f"(phase 8: {phase8['points']}); median |z - plane| {f_med:.6f} "
        f"(bar {FUSED_MEDIAN_BAR}), share < 0.5 {f_share:.5f} (bar "
        f"{FUSED_SHARE_BAR})")
    assert not differ, differ[:10]
    assert sorted(trees["two"]) == sorted(trees["one"])
    assert n_dmb == 4 * n_views and n_marks == 6 * n_views, (n_dmb, n_marks)
    assert [x["rank"] for x in ranks] == list(range(PHASE12_RANKS))
    assert all(x["world"] == PHASE12_RANKS for x in ranks)
    assert ranks[0]["files"] == written > 0, (ranks[0]["files"], written)
    assert all(x["files"] == 0 for x in ranks[1:]), ranks
    for x in ranks:
        assert x["zncc"] == want_zncc, (x, want_zncc)
        assert x["geom"] == want_geom, (x, want_geom)
    assert one_launches["zncc"] == PHASE12_RANKS * want_zncc, one_launches
    assert np.isfinite(pts).all()
    assert len(pts) >= FUSED_MIN_VIEW_SHARE * H * W, len(pts)
    assert f_med < FUSED_MEDIAN_BAR, f_med
    assert f_share > FUSED_SHARE_BAR, f_share
    for k in dense.values():
        shutil.rmtree(k)
    return {"wall": two_wall, "one_wall": one_wall, "ranks": ranks}


def time_ms(fn, reps):
    """ms per call of `fn` on the card: one warm-up, then `reps` calls
    between two CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def ablate_bound(inputs, mode, Hg, W, T):
    """(bound ms, what bounds it) of one ablation launch on the K = 8
    packed grid with T taps: the mode's FP32 operations at the FP32 peak,
    or the bytes it must move (planes, the sources it reads, tap weights,
    reference sums and costs) at the memory rate."""
    V, Hs, Ws = inputs.src_imgs.shape
    nv = int(inputs.view_mask.sum())
    evals = 8 * nv * T * Hg * W
    nbytes = (8 * Hg * W * 16 + ABLATE_SRC_BYTES[mode] * nv * Hs * Ws
              + 2 * T * Hg * W * 4 + 3 * Hg * W * 4 + 8 * Hg * W * V * 4)
    t_ops = evals * ABLATE_OPS_PER_TAP_EVAL[mode] / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


SASS_CLASSES = ("ins", "ldg", "ldg_u8", "ldg32", "ldg128", "rcp", "i2f",
                "f2i", "frnd", "prmt", "lds", "stg", "stg128", "local")


def sass_counts(instrs):
    """Counts of the SASS instruction classes phase 9d reads: all
    instructions, global loads (LDG), byte loads, 32-bit loads, 16-byte
    loads, MUFU.RCP, the conversion classes I2F (and I2FP), F2I (and F2IP)
    and FRND, PRMT, shared loads (LDS), global stores (STG) and 16-byte
    ones, and local-memory loads and stores; and under "conv" the distinct
    conversion opcodes. An instruction under the never-true predicate @!PT
    is never issued and not counted."""
    c = dict.fromkeys(SASS_CLASSES, 0)
    conv = set()
    for ins in instrs:
        words = ins.split()
        if not words or words[0] == "@!PT":
            continue
        op = words[1] if words[0].startswith("@") else words[0]
        name, *mods = op.split(".")
        c["ins"] += 1
        if name.startswith(("I2F", "F2I", "FRND")):
            conv.add(op)
        if name == "LDG":
            c["ldg"] += 1
            c["ldg_u8"] += "U8" in mods
            c["ldg32"] += not set(mods) & {"U8", "S8", "U16", "S16", "64",
                                           "128"}
            c["ldg128"] += "128" in mods
        if name == "STG":
            c["stg"] += 1
            c["stg128"] += "128" in mods
        c["rcp"] += op.startswith("MUFU.RCP")
        c["i2f"] += name.startswith("I2F")
        c["f2i"] += name.startswith("F2I")
        c["frnd"] += name == "FRND"
        c["prmt"] += name == "PRMT"
        c["lds"] += name == "LDS"
        c["local"] += name in ("LDL", "STL")
    c["conv"] = sorted(conv)
    return c


def sass_report(lib, pattern):
    """{function name: {"all": counts, "loop": counts, "tap": counts,
    "tap_loops": n}} for every kernel in `lib` whose name matches
    `pattern`, from its SASS (cuobjdump, where the toolkit has it; None
    where it does not); counts as sass_counts. "loop" counts only the
    instructions between a backward branch and its target, every loop of
    the kernel (the hypothesis loops are unrolled); "tap" only the loops
    that hold a MUFU.RCP (the tap loop: the staging loops hold none), of
    which there are "tap_loops"; None where there is no such loop."""
    import re

    from acmmp_tpu_torch.kernels import _build

    tool = pathlib.Path(_build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if re.search(pattern, m.group(1)) else None
            if name:
                funcs[name] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if name and m:
            funcs[name].append((int(m.group(1), 16), m.group(2)))

    out = {}
    for name, instrs in funcs.items():
        loops = []
        for addr, ins in instrs:
            # a branch back to an earlier address (not the trap at the
            # end, a branch to itself) closes a loop
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)\s*$", ins)
            if m and int(m.group(1), 16) < addr:
                loops.append((int(m.group(1), 16), addr))

        def within(spans):
            return [ins for addr, ins in instrs
                    if any(lo <= addr <= hi for lo, hi in spans)]

        taps = [span for span in loops
                if any("MUFU.RCP" in ins for ins in within([span]))]
        out[name] = {"all": sass_counts(i for _, i in instrs),
                     "loop": sass_counts(within(loops)) if loops else None,
                     "tap": sass_counts(within(taps)) if taps else None,
                     "tap_loops": len(taps)}
    return out


def sass_line(c):
    """One line of sass_counts."""
    return ("{ins} instructions: LDG {ldg} (byte {ldg_u8}, 32-bit {ldg32}, "
            "16-byte {ldg128}), MUFU.RCP {rcp}, I2F {i2f}, F2I {f2i}, FRND "
            "{frnd} ({conv}), PRMT {prmt}, LDS {lds}, STG {stg} (16-byte "
            "{stg128}), LDL/STL {local}".format(**c))


def ab_time(label, first, new, reps=20, what="zncc.cu K=8", must_beat=True,
            ratio_bar=None):
    """A redesigned kernel (`new`) against its first design (`first`) on
    one field, timed in turns (first, new, new, first), each turn `reps`
    launches between CUDA events after a warm-up. With `must_beat` the
    new design must be the faster in every turn; with `ratio_bar` the
    ratio of the means must not exceed it. Returns (first ms, new ms),
    the means of their two turns."""
    t = {"first": [], "new": []}
    for name in ("first", "new", "new", "first"):
        t[name].append(time_ms(first if name == "first" else new, reps))
    f, n = statistics.fmean(t["first"]), statistics.fmean(t["new"])
    log(f"  {what} against its first design, {label}: first "
        f"{[round(x, 4) for x in t['first']]} ms, new "
        f"{[round(x, 4) for x in t['new']]} ms; means {f:.4f} and {n:.4f} "
        f"ms, ratio {n / f:.4f}"
        + ("" if ratio_bar is None else f" (bar {ratio_bar:.4f})"))
    if must_beat:
        assert max(t["new"]) < min(t["first"]), (what, label, t)
    if ratio_bar is not None:
        assert n / f <= ratio_bar, (what, label, n / f, ratio_bar)
    return f, n


def ablate_mode_of(fn_name):
    """The ablation mode of a mangled ablate_kernel<8, Mode, Src> name."""
    import re

    m = re.search(r"ModeE(\d)E([hf])E", fn_name)
    if not m:
        return fn_name
    if m.group(2) == "f":
        return "f32take"
    return ("full", "noext", "nobounds", "noscan")[int(m.group(1))]


def ptxas_registers(text):
    """{entry function: registers} from nvcc's -Xptxas -v output."""
    import re

    regs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
    return regs


def log_decomposition(label, t):
    """Print the shares of the first design of zncc.cu K=8 (csrc/ablate.cu
    `full`) that the ablation times `t` (ms by mode) attribute to each
    part of its work."""
    full = t["full"]
    parts = (("loads (full - noscan)", full - t["noscan"]),
             ("bilinear and moments (full - noext)", full - t["noext"]),
             ("per-tap placement (full - nobounds)", full - t["nobounds"]),
             ("u8 against f32 reads (f32take - full)", t["f32take"] - full))
    log(f"  decomposition of the first design of zncc.cu K=8 ({label}): "
        f"full {full:.4f} ms; "
        + "; ".join(f"{n} {d:.4f} ms = {d / full:.3f}" for n, d in parts))


def ablation_on_field(label, params, inp, planes, off, errs, time_plain):
    """Phase 9c on one K = 8 packed field: every mode against its plain
    version (the bars above; under ops/ablate.EXPOSING too), `full` (the
    first design of zncc.cu, frozen as the redesign's bitwise and timing
    yardstick) bitwise to zncc.cu and f32take bitwise to `full`, each mode
    timed at its own occupancy and at each of ABLATE_EQUAL_OCCUPANCY,
    zncc.cu timed in turns against `full`, and the decompositions
    printed. Adds each mode's largest |difference| at the
    shipped params into `errs`. Returns ({(setting, mode): (ms, bound ms,
    bound_by) or (ms,)}, {mode: plain ms} when `time_plain`)."""
    import torch

    from acmmp_tpu_torch.ops import ablate, cuda_ablate, cuda_ncc
    from acmmp_tpu_torch.ops import ncc as ncc_ops

    fvg = ncc_ops.make_view_geometry(inp.ref_cam, inp.src_cams)
    nv = int(inp.view_mask.sum())
    prep = cuda_ablate.prepare(inp.ref_img, inp.src_imgs, fvg, params, off)
    _, Hg, W, _ = planes.shape
    T = len(params.tap_offsets) ** 2
    log(f"phase 9c: ablation modes vs plain, {label}, grid {Hg}x{W}, "
        f"{nv} views")
    got = {m: cuda_ablate.ablate_cuda(m, planes, prep, params, nv)
           for m in ablate.MODES}
    zncc = cuda_ncc.multiview_zncc_cuda(
        inp.ref_img, inp.src_imgs, fvg, planes, params, row_pack_off=off,
        n_views=nv, prep=prep.zncc)
    full_bitwise = bool(torch.equal(got["full"], zncc))
    f32_bitwise = bool(torch.equal(got["f32take"], got["full"]))
    log(f"  full (first design) == zncc.cu K=8 bitwise {full_bitwise}; "
        f"f32take == full "
        f"bitwise {f32_bitwise}")
    assert full_bitwise and f32_bitwise, label
    # the sources the kernel reads, for the plain version under EXPOSING
    u8_src = ablate.widen_sources(inp.src_imgs)
    times, plain_ms = {}, {}
    for m in ablate.MODES:
        want = ablate.ablate_packed(m, inp.ref_img, inp.src_imgs, fvg,
                                    planes, params, off)
        a, b = got[m][..., :nv], want[..., :nv]
        d = (a - b).abs()
        errs[m] = max(errs[m], d.max().item())
        if m in ABLATE_CLOSE:
            bar = "1e-5 (1 + |x|)"
            ok = bool((d <= 1e-5 * (1 + b.abs())).all())
            bad = (d > 1e-5 * (1 + b.abs())).float().mean().item()
        else:
            bar = "ZNCC"
            bad = (d > ZNCC_ATOL + ZNCC_RTOL * b.abs()).float().mean().item()
            ok = bad < ZNCC_MAX_FRAC
        at_max = (a == params.cost_max).float().mean().item()
        del want, a, b, d
        log(f"  {m}: bad {bad:.2e} ({bar} bar) max|d| {errs[m]:.3e}, at "
            f"cost_max {at_max:.4f}")
        assert ok, (label, m, bad)
        if m in ablate.EXPOSING:
            xp = ablate.exposing_params(m, params)
            kx = cuda_ablate.ablate_cuda(m, planes, prep, xp, nv)[..., :nv]
            px = ablate.ablate_packed(m, inp.ref_img, u8_src, fvg, planes,
                                      xp, off)[..., :nv]
            within, info, worst = ablate.exposed_agreement(kx, px)
            log(f"  {m} under {ablate.EXPOSING[m]}: {within:.6f} of the "
                f"informative costs within 1e-5 of plain, relative (bar "
                f"{ABLATE_EXPOSED_SHARE}), largest {worst:.3e}; informative "
                f"{info:.4f} (bar {ABLATE_INFORMATIVE_MIN})")
            assert (info >= ABLATE_INFORMATIVE_MIN
                    and within >= ABLATE_EXPOSED_SHARE), (label, m, within,
                                                          info)
            del kx, px

        def kern(m=m):
            return cuda_ablate.ablate_cuda(m, planes, prep, params, nv)

        ms = time_ms(kern, 20)
        b_ms, b_by = ablate_bound(inp, m, Hg, W, T)
        times[("own", m)] = (ms, b_ms, b_by)
        if time_plain:
            plain_ms[m] = time_ms(lambda m=m: ablate.ablate_packed(
                m, inp.ref_img, inp.src_imgs, fvg, planes, params, off), 1)
        log(f"  {m}: kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{cuda_ablate.occupancy(m)} blocks per SM"
            + (f", plain {plain_ms[m]:.3f} ms" if time_plain else ""))
    field = "converged" if label.startswith("converged") else "random"
    ab_time(label, lambda: cuda_ablate.ablate_cuda(
        "full", planes, prep, params, nv),
        lambda: cuda_ncc.multiview_zncc_cuda(
            inp.ref_img, inp.src_imgs, fvg, planes, params, row_pack_off=off,
            n_views=nv, prep=prep.zncc),
        ratio_bar=ZNCC_U8_RATIO_PR5[field] * ZNCC_U8_RATIO_SLACK)
    log_decomposition(f"{label}, own occupancy",
                      {m: times[("own", m)][0] for m in ablate.MODES})
    for name, smem, carve in ABLATE_EQUAL_OCCUPANCY:
        blocks = {m: cuda_ablate.occupancy(m, smem, carve)
                  for m in ablate.MODES}
        for m in ablate.MODES:
            def kern(m=m):
                return cuda_ablate.ablate_cuda(m, planes, prep, params, nv,
                                               smem, carve)

            # the launch's shared memory changes no bit of what it computes
            assert torch.equal(kern(), got[m]), (label, name, m)
            times[(name, m)] = (time_ms(kern, 20),)
        log(f"  at {name}: blocks per SM by the occupancy calculator "
            f"{blocks}; ms " + ", ".join(
                f"{m} {times[(name, m)][0]:.4f}" for m in ablate.MODES))
        if carve < 0:
            assert set(blocks.values()) == {ABLATE_EQUAL_BLOCKS}, blocks
        log_decomposition(f"{label}, {name}",
                          {m: times[(name, m)][0] for m in ablate.MODES})
    return times, plain_ms


def run_ablation_phase(dev, big, random8):
    """Phase 9: the lane probes, then the ZNCC cost decomposition. The
    probes are held bitwise to their plain versions on the card and to
    numpy, on the probe tool's words and nan_take_probe's adversarial
    ones, and timed beside torch.gather / torch.where. The tool's fields
    are built at its defaults (1600x1184, 8 sources) and its main path
    (nan_take_probe, then every mode timed; then mosaic_probe) runs with
    the launch counts reset. Then on the tool's converged field and on
    phase 6's random K = 8 field (`random8`, packed at off0 = 0 on the
    scene `big`) each mode is held to its plain version, `full` (the
    first design of zncc.cu) bitwise to zncc.cu and f32take bitwise to
    `full`, each mode is timed at its own occupancy and at 3 blocks per
    SM, zncc.cu in turns against `full`, and the decompositions of the
    first design printed (ablation_on_field); last, each mode's and each
    zncc.cu K's registers and SASS counts, zncc.cu's tap loop held to its
    design. Returns the JSON rows of the modes and the probes."""
    import torch

    from acmmp_tpu_torch.kernels import _build
    from acmmp_tpu_torch.ops import (ablate, cuda_ablate, cuda_ncc,
                                     cuda_probes, probes)
    from acmmp_tpu_torch.tools import mosaic_probe, prop_ablate

    rows = []
    # ---- 9a: the probes against plain and numpy, and their times ----
    log("phase 9a: lane probes vs plain (on the card) and numpy, bitwise")
    words, idx, sh = mosaic_probe.probe_inputs(0)
    sel = np.random.default_rng(1).integers(0, 2, (8, 128)) == 1
    adv_w, adv_idx, adv_sel = prop_ablate.adversarial_words()
    sets = {"words": dict(w=words, idx=idx, shift=sh, sel=sel),
            "adversarial": dict(w=adv_w, idx=adv_idx, shift=sh, sel=adv_sel)}
    probe_err = {name: 0 for name in probes.PROBES}
    for kind, arrs in sets.items():
        on_dev = {k: torch.as_tensor(a, device=dev) for k, a in arrs.items()}
        outs = {}
        for name in probes.PROBES:
            args = [on_dev[a] for a in ("w",) + cuda_probes.ARGS[name]]
            got = cuda_probes.probe_cuda(name, *args)
            plain = probes.PLAIN[name](*args)
            want = probes.numpy_reference(name, **arrs)
            same = (torch.equal(got.view(torch.int32), plain.view(torch.int32))
                    and np.array_equal(got.cpu().numpy().view(np.int32),
                                       want.view(np.int32)))
            # |difference| of the 32-bit patterns (0 when bitwise equal)
            probe_err[name] = max(probe_err[name], (
                got.view(torch.int32).long()
                - plain.view(torch.int32).long()).abs().max().item())
            log(f"  {kind} {name}: bitwise plain and numpy {same}")
            assert same, (kind, name)
            outs[name] = got
        assert torch.equal(outs["take_select_f32"], outs["take_select_i32"])

    on_dev = {k: torch.as_tensor(a, device=dev)
              for k, a in sets["adversarial"].items()}
    idx64 = on_dev["idx"].long()
    idx64_rows = torch.remainder(idx64, 8)
    wf = on_dev["w"].view(torch.float32)
    library = {
        "taa_i32_axis1": lambda: torch.gather(on_dev["w"], 1, idx64),
        "taa_i32_axis0": lambda: torch.gather(on_dev["w"], 0, idx64_rows),
        "take_select_i32": lambda: torch.where(
            on_dev["sel"], torch.gather(on_dev["w"], 1, idx64), on_dev["w"]),
        "take_select_f32": lambda: torch.where(
            on_dev["sel"], torch.gather(wf, 1, idx64), wf)}
    probe_times = {}
    for name in probes.PROBES:
        args = [on_dev[a] for a in ("w",) + cuda_probes.ARGS[name]]
        ms = time_ms(lambda: cuda_probes.probe_cuda(name, *args), 200)
        plain_ms = time_ms(lambda: probes.PLAIN[name](*args), 200)
        lib_ms = (time_ms(library[name], 200) if name in library else None)
        nbytes = sum(on_dev[a].numel() * on_dev[a].element_size()
                     for a in ("w",) + cuda_probes.ARGS[name]) + 8 * 128 * 4
        probe_times[name] = (ms, plain_ms, lib_ms, nbytes)
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
            f"{nbytes} bytes")

    # ---- 9b: the tool's fields and its main path, counted ----
    width, height, views = ABLATE_SHAPE
    t0 = time.perf_counter()
    fields = prop_ablate.build_fields(height, width, views, dev)
    log(f"phase 9b: prop_ablate's fields at {width}x{height}, {views} "
        f"sources, built in {time.perf_counter() - t0:.2f} s (host)")
    torch.cuda.synchronize()
    cuda_ablate.reset_launch_counts()
    cuda_probes.reset_launch_counts()
    tool_ms, probe_ok = prop_ablate.run_modes(fields, ablate.MODES, 3)
    mosaic_rc = mosaic_probe.main(["--device", str(dev)])
    torch.cuda.synchronize()
    ablate_counts = dict(cuda_ablate.launches)
    probe_counts = dict(cuda_probes.launches)
    log(f"  launches: ablate {ablate_counts}, probes {probe_counts}; "
        f"tool ms per call {tool_ms}")
    assert probe_ok and mosaic_rc == 0
    assert all(v > 0 for v in ablate_counts.values()), ablate_counts
    assert all(v > 0 for v in probe_counts.values()), probe_counts

    # ---- 9c: each mode against its plain version, timed, on two fields ----
    params, inputs, vg, cand, off0 = fields
    field_sets = (("converged relief field", inputs, cand, off0),
                  ("phase 6 random field", big, random8, 0))
    errs = {m: 0.0 for m in ablate.MODES}
    mode_times = {}
    for label, inp, planes, off in field_sets:
        converged = label.startswith("converged")
        times, plain_ms = ablation_on_field(label, params, inp, planes, off,
                                            errs, converged)
        if converged:
            mode_times = {m: (times[("own", m)], plain_ms[m])
                          for m in ablate.MODES}

    # ---- 9d: what each mode and each zncc.cu K compiled to ----
    import re

    regs = ptxas_registers(_build.BUILD_LOG.get("ablate", ""))
    for fn_name, r in sorted(regs.items()):
        if "ablate_kernel" in fn_name:
            # 128-thread blocks an SM holds by registers: 65,536 of them,
            # allocated per warp in units of 256
            per_block = 4 * -(-r * 32 // 256) * 256
            blocks = min(65536 // per_block, 16)
            log(f"phase 9d: {ablate_mode_of(fn_name)}: {r} registers, "
                f"{blocks} blocks ({4 * blocks} warps) per SM by registers")
    sass = sass_report(_build._target("ablate"), "ablate_kernel")
    zsass = sass_report(_build._target("zncc"), "zncc_kernel")
    gsass = sass_report(_build._target("geom"), "geom_kernelI")
    # the SASS counts are the check that each ablation removed what it
    # claims and nvcc nothing more, and that zncc.cu's tap loop and
    # geom.cu's view loop are what their designs say: without cuobjdump
    # the phase fails
    assert sass is not None and zsass is not None and gsass is not None, (
        "cuobjdump not found beside nvcc: no SASS counts")
    # every K on both source types, for one view and for a batch
    assert len(zsass) == 4 * len(cuda_ncc.SUPPORTED_K), sorted(zsass)
    for fn_name, c in sorted(sass.items()):
        loop = ("no backward branch found" if c["loop"] is None
                else sass_line(c["loop"]))
        log(f"phase 9d: {ablate_mode_of(fn_name)}: SASS {sass_line(c['all'])}"
            f"; in its loops: {loop}")
    for fn_name, c in sorted(zsass.items()):
        m = re.search(r"zncc_kernelILi(\d+)E(j|6float4)Lb([01])E", fn_name)
        assert m, fn_name
        K, f32 = int(m.group(1)), m.group(2) == "6float4"
        kind = ("float sources" if f32 else "8-bit sources") + (
            ", batched" if m.group(3) == "1" else "")
        tap = ("no loop with a MUFU.RCP found" if c["tap"] is None
               else sass_line(c["tap"]))
        log(f"phase 9d: zncc.cu K={K}, {kind}: SASS {sass_line(c['all'])}; "
            f"in the tap loop ({c['tap_loops']} found): {tap}")
        # one thread per (pixel, hypothesis), so per hypothesis and tap:
        # one source element, a 32-bit word of bytes or a 16-byte quad of
        # floats (K=1 also reads its two tap weights from global memory;
        # K>1 from shared memory, beside the taps), one reciprocal, four
        # byte selects on 8-bit sources and none on float ones, and no
        # conversion; no local memory anywhere
        t = c["tap"]
        assert c["tap_loops"] == 1 and t is not None, (K, kind, c)
        weights = 2 if K == 1 else 0
        assert t["ldg"] == 1 + weights, (K, kind, t)
        assert t["ldg128"] == (1 if f32 else 0), (K, kind, t)
        assert t["ldg32"] == weights + (0 if f32 else 1), (K, kind, t)
        assert t["lds"] == (1 if K == 1 else 2), (K, kind, t)
        assert t["rcp"] == 1 and t["prmt"] == (0 if f32 else 4), (K, kind, t)
        assert t["i2f"] == t["f2i"] == t["frnd"] == 0, (K, kind, t)
        assert c["all"]["local"] == 0, (K, kind, c["all"])
    # geom.cu's redesign, both instantiations: the view loop holds the
    # (hypothesis, view) part, GEOM_RCP_PER_VIEW IEEE divisions per view,
    # four views and one 16-byte store per iteration where V is a
    # multiple of 4, else one view and one 4-byte store
    assert len(gsass) == 4, sorted(gsass)
    for fn_name, c in sorted(gsass.items()):
        vec4 = "geom_kernelILb1E" in fn_name
        batched = "Lb1EEEv" in fn_name
        views = 4 if vec4 else 1
        loop = ("no loop with a MUFU.RCP found" if c["tap"] is None
                else sass_line(c["tap"]))
        log(f"phase 9d: geom.cu, {'V % 4 == 0' if vec4 else 'other V'}"
            f"{', batched' if batched else ''}: "
            f"SASS {sass_line(c['all'])}; in the view loop "
            f"({c['tap_loops']} found, {views} views an iteration): {loop}")
        t = c["tap"]
        assert c["tap_loops"] == 1 and t is not None, (fn_name, c)
        assert t["rcp"] == GEOM_RCP_PER_VIEW * views, (fn_name, t)
        assert t["stg"] == 1 and t["stg128"] == (1 if vec4 else 0), (
            fn_name, t)
        assert c["all"]["local"] == 0, (fn_name, c["all"])
    # each ablation removed what it claims from its tap loop, and nvcc
    # removed nothing more: the same byte loads in full, noext and
    # nobounds, none in noscan (nor anywhere in it), f32 words instead in
    # f32take; the same reciprocals but in nobounds, which has none
    loop = {ablate_mode_of(n): c["loop"] for n, c in sass.items()}
    assert sorted(loop) == sorted(ablate.MODES), loop
    assert all(v is not None for v in loop.values()), loop
    ldg, u8, rcp = ({m: v[key] for m, v in loop.items()}
                    for key in ("ldg", "ldg_u8", "rcp"))
    assert u8["full"] == u8["noext"] == u8["nobounds"] > 0, loop
    assert u8["noscan"] == u8["f32take"] == 0, loop
    assert ldg["f32take"] == ldg["full"], loop
    assert rcp["full"] == rcp["noext"] == rcp["noscan"] == rcp[
        "f32take"] > 0 == rcp["nobounds"], loop
    assert [c["all"]["ldg_u8"] for n, c in sass.items()
            if ablate_mode_of(n) == "noscan"] == [0], sass

    for m in ablate.MODES:
        (ms, b_ms, b_by), plain_ms = mode_times[m]
        rows.append({
            "name": f"ablate_{m}", "route": "cuda",
            "source": "acmmp_tpu_torch/csrc/ablate.cu",
            "replaces": ABLATE_TPU_KERNEL, "launches": ablate_counts[m],
            "max_abs_err": errs[m], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    for name in probes.PROBES:
        ms, plain_ms, lib_ms, nbytes = probe_times[name]
        rows.append({
            "name": f"probe_{name}", "route": "cuda",
            "source": "acmmp_tpu_torch/csrc/probes.cu",
            "replaces": PROBE_TPU_KERNEL[name],
            "launches": probe_counts[name],
            "max_abs_err": float(probe_err[name]), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": lib_ms})
    return rows


def module_versions(names):
    """'name version' (or 'name missing') of each host module."""
    import importlib

    out = []
    for name in names:
        try:
            mod = importlib.import_module(name)
        except ImportError:
            out.append(f"{name} missing")
        else:
            out.append(f"{name} {getattr(mod, '__version__', '?')}")
    return out


def png_decode_times():
    """read_png's wall on a 1600x1200 16-bit normal prior that OpenCV
    wrote, with its default row filter and with each filter it offers,
    each decode held to OpenCV's own (information: not bounded)."""
    try:
        import cv2
    except ImportError:
        return ["not measured (no cv2)"]
    from acmmp_tpu_torch.io.priors import read_png

    h, w = 1200, 1600
    rng = np.random.default_rng(0)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    n = np.stack([np.sin(xs / 200) + 0.05 * rng.standard_normal((h, w)),
                  np.cos(ys / 150), np.ones_like(xs)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    arr = np.clip((n + 1.0) * 32768.0, 0, 65535).astype(np.uint16)
    filters = [("default", [])] + [
        (name, [cv2.IMWRITE_PNG_FILTER, getattr(cv2, f"IMWRITE_PNG_{name}")])
        for name in ("FILTER_PAETH", "FILTER_AVG", "ALL_FILTERS")
        if hasattr(cv2, "IMWRITE_PNG_FILTER")]
    out = []
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "n.png")
        for name, flags in filters:
            assert cv2.imwrite(path, arr, flags), name
            t0 = time.perf_counter()
            got = read_png(path)
            sec = time.perf_counter() - t0
            np.testing.assert_array_equal(
                got, cv2.imread(path, cv2.IMREAD_UNCHANGED))
            np.testing.assert_array_equal(got, arr)
            out.append(f"{name} {sec:.3f} s")
    return out


class SolveCounter:
    """Counts the problems solved through BatchedSolver.solve_batch (all,
    and in seeded mode) while it is entered."""

    def __enter__(self):
        from acmmp_tpu_torch.pipeline.batched import BatchedSolver

        self.cls, self.orig = BatchedSolver, BatchedSolver.solve_batch
        self.solves = self.seeded = 0
        counter = self

        def solve_batch(solver, inputs_list, keys_list, mode, **kw):
            counter.solves += len(inputs_list)
            counter.seeded += len(inputs_list) if mode.seeded else 0
            return counter.orig(solver, inputs_list, keys_list, mode, **kw)

        BatchedSolver.solve_batch = solve_batch
        return self

    def __exit__(self, *exc):
        self.cls.solve_batch = self.orig


def reset_counts():
    from acmmp_tpu_torch.ops import cuda_geom, cuda_ncc, cuda_sample

    for c in (cuda_ncc, cuda_geom, cuda_sample):
        c.reset_launch_counts()


def read_counts():
    """The launch counts of the main path's kernels: zncc.cu by K (8-bit
    sources), geom.cu by K, sample.cu in all and by the maps' channel
    count C."""
    from acmmp_tpu_torch.ops import cuda_geom, cuda_ncc, cuda_sample

    return {"zncc": dict(cuda_ncc.launches), "geom": dict(cuda_geom.launches),
            "sample": dict(cuda_sample.launches),
            "sample_c": dict(cuda_sample.launches_by_channels)}


def assert_sampler_widths(counts, what):
    """sample.cu's launches by width add up to its launches in all."""
    assert sum(counts["sample_c"].values()) == \
        counts["sample"]["gather2d"], (what, counts["sample"],
                                       counts["sample_c"])


def assert_13_per_solve(counts, solves, what):
    """13 zncc.cu launches per solve: one K=1 init, then K=8, 3 and 2 in
    each of the 4 half-sweeps."""
    z = counts["zncc"]
    assert solves > 0 and z[1] == solves and z[8] == z[3] == z[2] == 4 * \
        solves, (what, z, solves)


def run_dtu_grid_phase(work, dev):
    """Phase 10: the rest of the CLI and the DTU method grid on the card.
    Through acmmp_tpu_torch.cli.main in this process: make-synthetic
    --relief at a few views against the library call; the grid's scan
    (49 views of the same surface on the full-scale tool's convergent rig)
    with its ground-truth PLY from relief_gt_points; analyze-dtu over
    camera subsets 3 and 5 with the GT root (five variants each, the
    seeded re-runs among them); then, on the 3-camera subset, select-cams,
    eval-dtu --json and make-priors against what the grid made and the
    library calls. Launch counts are set to 0 just before analyze-dtu and
    read just after; each variant's pipeline is timed and counted on its
    own."""
    import contextlib
    import io

    import torch

    from acmmp_tpu_torch import cli
    from acmmp_tpu_torch.eval.dtu import METRIC_NAMES, evaluate_ply
    from acmmp_tpu_torch.experiments import dtu_analysis
    from acmmp_tpu_torch.experiments.fixtures import (
        write_synthetic_dense_folder)
    from acmmp_tpu_torch.experiments.prior_sampler import (
        write_priors_from_points)
    from acmmp_tpu_torch.io import read_ply, write_ply
    from acmmp_tpu_torch.io.dense_folder import load_cams
    from acmmp_tpu_torch.io.priors import read_png
    from acmmp_tpu_torch.utils.synth import (relief_gt_points,
                                             textured_relief_scene,
                                             write_dense_folder)

    W, H, V = GRID_SHAPE

    def run_cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        assert rc == 0, (argv, rc)
        return buf.getvalue()

    def same_tree(a, b, subs):
        """The same files, byte for byte, under each of `subs` of `a` and
        `b`; returns how many."""
        def files(root):
            return sorted(os.path.relpath(os.path.join(d, f), root)
                          for sub in subs
                          for d, _, fs in os.walk(os.path.join(root, sub))
                          for f in fs)

        names = files(a)
        assert names == files(b), (names, files(b))
        for n in names:
            assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                               shallow=False), n
        return len(names)

    t0 = time.perf_counter()
    made, lib = os.path.join(work, "made"), os.path.join(work, "made_lib")
    run_cli(["make-synthetic", made, "--relief", "--n_views",
             str(MADE_VIEWS), "--width", str(W), "--height", str(H)])
    write_synthetic_dense_folder(lib, n_views=MADE_VIEWS, width=W, height=H,
                                 relief=True)
    n_made = same_tree(made, lib, ("",))
    log(f"phase 10: make-synthetic --relief wrote {MADE_VIEWS} views at "
        f"{W}x{H} ({n_made} files), byte-equal to the library call, in "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    images, cams, _ = textured_relief_scene(
        n_views=V, width=W, height=H, f=140.0 * W / 96.0, spread=1.2,
        converge=True)
    scans, out_root, gt_root = (os.path.join(work, d)
                                for d in ("scans", "grid", "gt"))
    write_dense_folder(os.path.join(scans, "relief"), images, cams)
    used = sorted({v for n in GRID_CAM_COUNTS
                   for v in dtu_analysis.DTU_CAM_SETS[n]})
    gt = relief_gt_points([cams[v] for v in used], W, H, samples=(H, W))
    os.makedirs(gt_root)
    write_ply(os.path.join(gt_root, "relief.ply"), gt.astype(np.float32),
              np.zeros(gt.shape, np.float32), np.zeros(gt.shape, np.uint8))
    log(f"  grid scan {V} views on the convergent rig and its GT "
        f"({len(gt)} points over views {used}) in "
        f"{time.perf_counter() - t0:.1f} s")

    # each variant's pipeline: wall, launches by kernel and sampler width,
    # solves (seeded among them)
    per_run, tables = [], []
    orig_pipeline = dtu_analysis.run_pipeline
    orig_grid = dtu_analysis.analyze_dtu_scans

    def timed_pipeline(dense, cfg, device=None):
        before = read_counts()
        with SolveCounter() as sc:
            t = time.perf_counter()
            ply = orig_pipeline(dense, cfg, device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        after = read_counts()
        per_run.append({
            "dense": os.path.basename(dense), "output_dir": cfg.output_dir,
            "wall": wall, "solves": sc.solves, "seeded": sc.seeded,
            "zncc": {k: after["zncc"][k] - before["zncc"][k]
                     for k in after["zncc"]},
            "geom": {k: after["geom"][k] - before["geom"][k]
                     for k in after["geom"]},
            "sample": {c: after["sample_c"].get(c, 0)
                       - before["sample_c"].get(c, 0)
                       for c in SAMPLE_CHANNELS},
            "gather2d": after["sample"]["gather2d"]
            - before["sample"]["gather2d"]})
        return ply

    def kept_grid(*a, **kw):
        tables.append(orig_grid(*a, **kw))
        return tables[-1]

    dtu_analysis.run_pipeline = timed_pipeline
    dtu_analysis.analyze_dtu_scans = kept_grid
    reset_counts()
    t0 = time.perf_counter()
    try:
        with SolveCounter() as total:
            out = run_cli(["analyze-dtu", scans, out_root, "--cam_counts",
                           ",".join(map(str, GRID_CAM_COUNTS)), "--gt_root",
                           gt_root, "--device", str(dev)])
    finally:
        dtu_analysis.run_pipeline = orig_pipeline
        dtu_analysis.analyze_dtu_scans = orig_grid
    wall = time.perf_counter() - t0
    counts = read_counts()
    by_c = counts["sample_c"]
    log(f"  analyze-dtu {scans} --cam_counts {GRID_CAM_COUNTS} in "
        f"{wall:.1f} s: {total.solves} solves ({total.seeded} seeded), "
        f"launches {counts}")
    for line in out.strip().splitlines():
        log(f"  {line}")
    assert_13_per_solve(counts, total.solves, "phase 10")
    assert total.seeded > 0, total.seeded
    assert all(v > 0 for k in ("zncc", "geom") for v in counts[k].values()), \
        counts
    assert_sampler_widths(counts, "phase 10")
    assert set(by_c) == set(SAMPLE_CHANNELS), by_c
    assert out.count(" vs ") == 2 * 10, out       # 2 metrics x 5C2 pairs

    table, = tables
    for n_cam in GRID_CAM_COUNTS:
        dense = os.path.join(out_root, f"relief_{n_cam}_cam")
        runs = {r["output_dir"]: r for r in per_run
                if r["dense"] == os.path.basename(dense)}
        for variant, (out_dir, ply_name) in GRID_VARIANTS.items():
            r = runs[out_dir]
            pts, _, _ = read_ply(os.path.join(dense, ply_name))
            m = table.rows[(variant, "relief", n_cam)]
            log(f"  {n_cam} cams {variant:12s}: wall {r['wall']:.2f} s, "
                f"{r['solves']} solves ({r['seeded']} seeded), sampler "
                f"C=4 {r['sample'][4]} C=8 {r['sample'][8]}, {len(pts)} "
                f"points; " + " ".join(f"{k} {v:.4f}" for k, v in
                                       zip(METRIC_NAMES, m)))
            assert len(pts) >= GRID_MIN_FUSED_SHARE * W * H, (
                n_cam, variant, len(pts))
            assert m.shape == (12,) and np.isfinite(m).all(), (variant, m)
            assert_13_per_solve(r, r["solves"], (n_cam, variant))
            assert sum(r["sample"].values()) == r["gather2d"], (variant, r)
            want_seeded = variant in ("boost_1", "boost_single",
                                      "full_prior")
            assert (r["seeded"] > 0) == want_seeded, (variant, r)
            assert (r["sample"][8] > 0) == (variant in ("x2", "boost_1")), \
                (variant, r)

    # select-cams, eval-dtu --json and make-priors through the CLI against
    # what the grid made and the library calls
    dense = os.path.join(out_root, f"relief_{GRID_CAM_COUNTS[0]}_cam")
    sel = os.path.join(work, "selected")
    run_cli(["select-cams", os.path.join(scans, "relief"), sel, "--cams",
             ",".join(map(str, dtu_analysis.DTU_CAM_SETS[
                 GRID_CAM_COUNTS[0]]))])
    same_tree(sel, dense, ("images", "cams"))
    assert filecmp.cmp(os.path.join(sel, "pair.txt"),
                       os.path.join(dense, "pair.txt"), shallow=False)
    ply = os.path.join(dense, "ACMMP_no_prior.ply")
    got = json.loads(run_cli(["eval-dtu", ply, "--gt",
                              os.path.join(gt_root, "relief.ply"),
                              "--json"]))
    gt32, _, _ = read_ply(os.path.join(gt_root, "relief.ply"))
    assert got == evaluate_ply(ply, gt32), got
    np.testing.assert_array_equal(
        [got[k] for k in METRIC_NAMES],
        table.rows[("no_prior", "relief", GRID_CAM_COUNTS[0])])
    a, b = os.path.join(work, "priors_cli"), os.path.join(work, "priors_lib")
    for d in (a, b):
        for sub in ("images", "cams"):
            shutil.copytree(os.path.join(dense, sub), os.path.join(d, sub))
    run_cli(["make-priors", a, "--ply", ply])
    pts, _, _ = read_ply(ply)
    write_priors_from_points(b, pts, load_cams(b))
    for sub in ("depths", "normals"):
        names = sorted(os.listdir(os.path.join(a, "priors", sub)))
        assert names == sorted(os.listdir(os.path.join(b, "priors", sub)))
        assert len(names) == GRID_CAM_COUNTS[0]
        for n in names:
            np.testing.assert_array_equal(
                read_png(os.path.join(a, "priors", sub, n)),
                read_png(os.path.join(b, "priors", sub, n)))
    log(f"  select-cams, eval-dtu --json and make-priors through the CLI "
        f"equal the grid's folder and the library calls "
        f"({GRID_CAM_COUNTS[0]} cams)")
    return {"counts": counts, "by_c": by_c, "solves": total.solves,
            "seeded": total.seeded, "wall": wall, "runs": per_run}


def run_fullscale_phase(work, dev):
    """Phase 10b: the port's fullscale_quality at its defaults (1280x960,
    6 views, geom_iters 2, the default random law), launch counts set to
    0 just before and read just after; its 12 metrics held to
    FULLSCALE_BARS."""
    from acmmp_tpu_torch.tools import fullscale_quality

    reset_counts()
    with SolveCounter() as sc:
        res = fullscale_quality.main(
            ["--dense", os.path.join(work, "fullscale"), "--device",
             str(dev), "--out", os.path.join(work, "fullscale.json")])
    counts = read_counts()
    m = res["metrics"]
    log(f"phase 10b: fullscale_quality {res['shape']}, {res['views']} "
        f"views, window {res['rand_depth_tile_window']}, min_cos "
        f"{res['rand_normal_min_cos']} on {res['device']}: pipeline wall "
        f"{res['pipeline_wall_s']:.2f} s, {sc.solves} solves, launches "
        f"{counts}, {res['points']} points")
    log(f"  scene {res['scene_s']:.2f} s, GT {res['gt_s']:.2f} s "
        f"({res['gt_points']} points)")
    log(f"  eval {res['eval_s']:.2f} s")
    log("  metrics " + " ".join(f"{k} {v}" for k, v in m.items()))
    assert_13_per_solve(counts, sc.solves, "phase 10b")
    assert counts["sample"]["gather2d"] == res["views"], counts
    assert all(math.isfinite(v) for v in m.values()), m
    assert m["acc2"] >= FULLSCALE_BARS["acc2"], m
    assert m["cmp2"] >= FULLSCALE_BARS["cmp2"], m
    assert m["acc_mean"] <= FULLSCALE_BARS["acc_mean"], m
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_script = time.perf_counter()
    mark("setup")
    card = card_line()
    log(f"card: {card}")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    from acmmp_tpu_torch.config import PatchMatchParams
    from acmmp_tpu_torch.core import geometry as geo
    from acmmp_tpu_torch.engine.inputs import build_solver_inputs
    from acmmp_tpu_torch.engine.patchmatch import Mode, run_patchmatch
    from acmmp_tpu_torch.kernels import _build
    from acmmp_tpu_torch.ops import cuda_ablate, cuda_geom, cuda_ncc, keys
    from acmmp_tpu_torch.ops import geom as geom_ops
    from acmmp_tpu_torch.ops import ncc as ncc_ops
    from acmmp_tpu_torch.ops import parity, sampling
    from acmmp_tpu_torch.utils.synth import (textured_plane_scene,
                                             textured_relief_scene,
                                             write_dense_folder)

    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    # information only: the host modules the CLI's subcommands may use
    log("host modules: " + ", ".join(
        module_versions(("cv2", "matplotlib", "PIL", "scipy"))))
    log("read_png on OpenCV's 1600x1200 normal priors, by row filter: "
        + ", ".join(png_decode_times()))

    # ---- phase 2: build ----
    mark("2")
    t0 = time.perf_counter()
    names = _build.all_kernels()
    _build.build(names)
    log(f"phase 2: built {names} in {time.perf_counter() - t0:.2f} s")
    for name, text in _build.BUILD_LOG.items():
        log(f"nvcc {name}:\n{text.strip()}")

    params = PatchMatchParams()
    plain_params = PatchMatchParams(ncc_backend="plain")
    # float sources: the same solve without the 8-bit rounding
    f_params = PatchMatchParams(ncc_src_u8=False)

    def scene(width, height, n_src, num_views_pad=None, build=params):
        """The plane scene's solver inputs; `build` params with
        ncc_src_u8=False keep its real-valued pixels."""
        images, cams, plane_z = textured_plane_scene(
            n_views=n_src + 1, width=width, height=height,
            f=600.0 * width / 320.0, plane_z=5.0)
        inputs = build_solver_inputs(images[0], images[1:], cams[0],
                                     cams[1:], build,
                                     num_views_pad=num_views_pad,
                                     device=dev)
        return inputs, plane_z, (height, width)

    def true_planes(inputs, plane_z, K, seed):
        """K coherent fields, as propagation candidates are: the true
        plane at depths scaled by 1 +- 2% per k, with normals perturbed
        per pixel by up to 0.02 pi."""
        H, W = inputs.ref_img.shape
        x, y = geo.pixel_grid(H, W, device=dev)
        cam = inputs.ref_cam
        n_world = torch.tensor([0.0, 0.0, -1.0], device=dev).expand(H, W, 3)
        n_cam = geo.normal_world_to_cam(cam, n_world)
        out = []
        for k, kk in enumerate(keys.split(keys.key(seed), K)):
            d = torch.full((H, W), plane_z * (1.0 + 0.02 * (k - K // 2)),
                           device=dev)
            n = sampling.perturbed_normal(kk, cam, x, y, n_cam,
                                          0.02 * math.pi)
            out.append(geo.plane_from_depth_normal(cam, x, y, d, n))
        return torch.stack(out).contiguous()

    def random_planes(inputs, K, seed, window, min_cos):
        H, W = inputs.ref_img.shape
        x, y = geo.pixel_grid(H, W, device=dev)
        ks = keys.split(keys.key(seed), K)
        return torch.stack([sampling.random_plane(
            k, inputs.ref_cam, x, y, inputs.depth_min, inputs.depth_max,
            tile_window=window, min_cos=min_cos) for k in ks]).contiguous()

    max_err = {k: 0.0 for k in cuda_ncc.SUPPORTED_K}
    max_err_f32 = {k: 0.0 for k in cuda_ncc.SUPPORTED_K}

    def compare(inputs, planes, off0, label, origin=None, kparams=params):
        """Kernel vs plain on the same inputs; K-stack vs K=1 launches; a
        packed K=8 stack also bitwise against the kernel's first design
        (csrc/ablate.cu `full`, or `f32take` on float sources). On 8-bit
        sources the float-source instantiation, fed the same u8-valued
        floats, must give the 8-bit one's bits."""
        f32 = not kparams.ncc_src_u8
        pparams = dataclasses.replace(kparams, ncc_backend="plain")
        vg = ncc_ops.make_view_geometry(inputs.ref_cam, inputs.src_cams)
        nv = int(inputs.view_mask.sum())
        K = planes.shape[0]
        pk = planes if off0 is None else parity.pack_rows_c(
            planes, off0).contiguous()

        def run(p, hyps):
            if off0 is None:
                return ncc_ops.multiview_zncc(
                    inputs.ref_img, inputs.src_imgs, vg, hyps, p,
                    origin=origin, n_views=nv)
            return ncc_ops.multiview_zncc_packed(
                inputs.ref_img, inputs.src_imgs, vg, hyps, p, off0,
                origin=origin, n_views=nv)

        got = run(kparams, pk)
        ref = run(pparams, pk)
        torch.cuda.synchronize()
        a, b = got[..., :nv], ref[..., :nv]
        assert torch.isfinite(got).all(), label
        d = (a - b).abs()
        bad = (d > ZNCC_ATOL + ZNCC_RTOL * b.abs()).float().mean().item()
        err = d.max().item()
        errs = max_err_f32 if f32 else max_err
        errs[K] = max(errs[K], err)
        pad_ok = bool((got[..., nv:] == kparams.cost_max).all())
        singles = [run(kparams, pk[k:k + 1].contiguous()) for k in range(K)]
        bitwise = bool(torch.equal(torch.cat(singles), got))
        extra = ""
        if K == 8 and off0 is not None and origin is None:
            if f32:
                # the first design on the same f32 sources
                aprep = cuda_ablate.AblatePrep(
                    cuda_ncc.prepare(inputs.ref_img, inputs.src_imgs, vg,
                                     kparams, off0),
                    inputs.src_imgs.contiguous())
                mode = "f32take"
            else:
                aprep = cuda_ablate.prepare(inputs.ref_img, inputs.src_imgs,
                                            vg, kparams, off0)
                mode = "full"
            same = bool(torch.equal(
                cuda_ablate.ablate_cuda(mode, pk, aprep, kparams, nv), got))
            extra += f" == first design ({mode}) {same}"
            assert same, label
        if not f32:
            same = bool(torch.equal(run(f_params, pk), got))
            extra += f" float-source instantiation == 8-bit {same}"
            assert same, label
        log(f"  {label}: K={K} {'float' if f32 else '8-bit'} sources shape "
            f"{tuple(got.shape)} bad {bad:.2e} max|d| {err:.3e} padded-slot "
            f"cost_max {pad_ok} K-stack==K x K=1 {bitwise}{extra}")
        assert bad < ZNCC_MAX_FRAC, (label, bad)
        assert pad_ok, label
        assert bitwise, label

    # ---- phase 3: kernel against plain ----
    mark("3")
    log("phase 3: kernel vs plain, 320x240, 4 sources (+1 padded slot)")
    small, plane_z, _ = scene(320, 240, 4, num_views_pad=5)
    assert int(small.view_mask.sum()) == 4 and small.src_imgs.shape[0] == 5
    for K, off0 in ((1, None), (8, 0), (8, 1), (3, 0), (2, 1)):
        compare(small, true_planes(small, plane_z, K, K), off0,
                f"coherent off0={off0}")
        compare(small, random_planes(small, K, 10 + K, 0.125, 0.25), off0,
                f"random window+cap off0={off0}")
        compare(small, random_planes(small, K, 20 + K, 0.0, 0.0), off0,
                f"random exact off0={off0}")
    compare(small, random_planes(small, 2, 25, 0.125, 0.25), 1,
            "random window+cap off0=1 tile origin (16, 0)", origin=(16, 0))

    # the chain's two scales (phase 7): 9 views at 800x592 (f = 1500) and
    # 1600x1184 (f = 3000), the texture at CHAIN_TEXTURE_SCALE
    chain_scenes = {}
    for width, height, f in ((800, 592, 1500.0), (1600, 1184, 3000.0)):
        chain_scenes[(width, height)] = textured_plane_scene(
            n_views=9, width=width, height=height, f=f, plane_z=5.0,
            texture_scale=CHAIN_TEXTURE_SCALE)

    big, plane_z_big, (h_big, w_big) = scene(1600, 1184, 8)
    images_c, cams_c, plane_z_c = chain_scenes[(800, 592)]
    coarse_in = build_solver_inputs(images_c[0], images_c[1:], cams_c[0],
                                    cams_c[1:], params, device=dev)
    for label, inputs, pz in (("1600x1184", big, plane_z_big),
                              ("800x592", coarse_in, plane_z_c)):
        log(f"phase 3b: kernel vs plain at the main paths' shapes, {label}, "
            f"8 sources")
        compare(inputs, random_planes(inputs, 1, 31, 0.125, 0.25), None,
                "init random window+cap")
        for K in (8, 3, 2):
            compare(inputs, true_planes(inputs, pz, K, 50 + K), 0,
                    "coherent off0=0")
        compare(inputs, random_planes(inputs, 8, 33, 0.125, 0.25), 0,
                "random window+cap off0=0")
        compare(inputs, random_planes(inputs, 8, 34, 0.0, 0.0), 1,
                "random exact off0=1")
        compare(inputs, random_planes(inputs, 2, 32, 0.125, 0.25), 1,
                "random window+cap off0=1")
    del coarse_in

    # ---- phase 3e: float sources through the kernel ----
    mark("3e")
    def real_share(src):
        """The share of source pixels that are not integers."""
        return (src != torch.round(src)).float().mean().item()

    def solve_agreement(inputs, kparams, key):
        """Phase 4's comparison: the solve through the kernel and through
        the plain version with the same key, and the plain version's
        agreement with itself under 1e-5 Gaussian noise on every ZNCC cost
        (tests/test_torch_solver.py's measure of how far argmin near-ties
        let two f32 evaluations of the same solve part). Returns ((share
        of interior depths within SOLVE_REL_TOL, within 5%) kernel vs
        plain, the same for noisy plain vs plain, the kernel's interior
        depth)."""
        h, w = inputs.ref_img.shape
        pparams = dataclasses.replace(kparams, ncc_backend="plain")
        out_k = run_patchmatch(inputs, key, kparams, Mode())
        out_p = run_patchmatch(inputs, key, pparams, Mode())
        clean = ncc_ops._zncc_grids
        gen = torch.Generator(device=dev).manual_seed(0)

        def noisy(*args):
            cost = clean(*args)
            return cost + 1e-5 * torch.randn(cost.shape, generator=gen,
                                             device=cost.device)

        ncc_ops._zncc_grids = noisy
        try:
            out_n = run_patchmatch(inputs, key, pparams, Mode())
        finally:
            ncc_ops._zncc_grids = clean
        torch.cuda.synchronize()
        r0, r1 = int(0.2 * h), int(0.8 * h)
        c0, c1 = int(0.19 * w), int(0.81 * w)
        dk = out_k.depth[r0:r1, c0:c1]
        dp = out_p.depth[r0:r1, c0:c1]

        def shares(d):
            rel = (d[r0:r1, c0:c1] - dp).abs() / dp.abs()
            return ((rel < SOLVE_REL_TOL).float().mean().item(),
                    (rel < 0.05).float().mean().item())

        return shares(out_k.depth), shares(out_n.depth), dk

    n_sweeps = 2 * params.max_iterations
    want_solve = {1: 1, 8: n_sweeps, 3: n_sweeps, 2: n_sweeps}
    small_f, plane_z_f, _ = scene(320, 240, 4, num_views_pad=5,
                                  build=f_params)
    big_f, plane_z_big_f, _ = scene(1600, 1184, 8, build=f_params)
    log(f"phase 3e: float sources (ncc_src_u8=False) through the kernel; "
        f"share of non-integer source pixels "
        f"{real_share(small_f.src_imgs[:4]):.4f} at 320x240, "
        f"{real_share(big_f.src_imgs):.4f} at 1600x1184")
    assert real_share(small_f.src_imgs[:4]) > 0.5
    assert real_share(big_f.src_imgs) > 0.5
    for K, off0 in ((1, None), (8, 0), (8, 1), (3, 0), (2, 1)):
        compare(small_f, true_planes(small_f, plane_z_f, K, K), off0,
                f"320x240 coherent off0={off0}", kparams=f_params)
        compare(small_f, random_planes(small_f, K, 10 + K, 0.125, 0.25),
                off0, f"320x240 random window+cap off0={off0}",
                kparams=f_params)
        compare(small_f, random_planes(small_f, K, 20 + K, 0.0, 0.0), off0,
                f"320x240 random exact off0={off0}", kparams=f_params)
    compare(big_f, random_planes(big_f, 1, 31, 0.125, 0.25), None,
            "1600x1184 init random window+cap", kparams=f_params)
    for K in (8, 3, 2):
        compare(big_f, true_planes(big_f, plane_z_big_f, K, 50 + K), 0,
                "1600x1184 coherent off0=0", kparams=f_params)
    compare(big_f, random_planes(big_f, 8, 33, 0.125, 0.25), 0,
            "1600x1184 random window+cap off0=0", kparams=f_params)
    compare(big_f, random_planes(big_f, 8, 34, 0.0, 0.0), 1,
            "1600x1184 random exact off0=1", kparams=f_params)
    compare(big_f, random_planes(big_f, 2, 32, 0.125, 0.25), 1,
            "1600x1184 random window+cap off0=1", kparams=f_params)
    del small_f

    # the relief solve of tests/test_relief.py, float sources, key 0
    r_params = PatchMatchParams(patch_size=7, ncc_src_u8=False)
    images_r, cams_r, gt_r = textured_relief_scene(n_views=4)
    relief = build_solver_inputs(images_r[0], images_r[1:], cams_r[0],
                                 cams_r[1:], r_params, pad_h=1, pad_w=1,
                                 device=dev)
    before = dict(cuda_ncc.launches_f32)
    out_r = run_patchmatch(relief, keys.key(0), r_params, Mode())
    torch.cuda.synchronize()
    d_r = {k: cuda_ncc.launches_f32[k] - before[k] for k in before}
    hr, wr = gt_r.shape
    interior = np.s_[8:hr - 8, 10:wr - 10]
    depth_r = out_r.depth.cpu().numpy()[:hr, :wr][interior]
    err_r = np.abs(depth_r - gt_r[interior])
    med_r, share_r = float(np.median(err_r)), float((err_r < 0.2).mean())
    corr_r = float(np.corrcoef(depth_r.ravel(), gt_r[interior].ravel())[0, 1])
    log(f"  relief 96x64, 3 sources, patch_size=7, float sources: launches "
        f"{d_r} (want {want_solve}); median |depth - gt| {med_r:.4f} (bar "
        f"{RELIEF_MEDIAN_BAR}), under 0.2 {share_r:.4f} (bar "
        f"{RELIEF_SHARE_BAR}), correlation {corr_r:.4f} (bar "
        f"{RELIEF_CORR_BAR})")
    assert d_r == want_solve, d_r
    assert med_r < RELIEF_MEDIAN_BAR and share_r > RELIEF_SHARE_BAR
    assert corr_r > RELIEF_CORR_BAR, corr_r
    del relief, out_r

    # phase 4's comparison on float sources. On this scene's smooth
    # texture the float-source solve is bound by argmin near-ties: 1e-5 of
    # cost noise leaves about 0.56-0.60 of the plain solve's interior
    # depths within 1%, against about 0.92 on 8-bit sources (PERF.md,
    # Findings), so the kernel is held to the solve's own noise floor
    # there and to SOLVE_MIN_SHARE within 5%
    small4_f, plane_z4_f, _ = scene(320, 240, 4, build=f_params)
    (share_f, share5_f), (noise_f, noise5_f), dk_f = solve_agreement(
        small4_f, f_params, keys.key(7))
    log(f"  320x240 float-source solve, kernel vs plain, same key: interior "
        f"depths within {SOLVE_REL_TOL:.0%}: {share_f:.4f} (bar: the plain "
        f"solve against itself under 1e-5 cost noise, {noise_f:.4f}); "
        f"within 5%: {share5_f:.4f} (bars {SOLVE_MIN_SHARE} and the noise "
        f"floor {noise5_f:.4f}); median |depth - z| kernel "
        f"{(dk_f - plane_z4_f).abs().median().item():.4f}")
    assert share_f >= noise_f and share5_f >= noise5_f, (
        share_f, noise_f, share5_f, noise5_f)
    assert share5_f >= SOLVE_MIN_SHARE, share5_f

    # ---- phase 3c: geom kernel against plain ----
    mark("3c")
    geom_err = {k: 0.0 for k in cuda_geom.SUPPORTED_K}

    def geom_rig(width, height, n_src, band_rows, num_views_pad=None):
        """The non-round rig of tests/test_pallas_geom.py scaled to width:
        the default rig puts view pairs at integer column shifts on the
        true plane, a truncation knife-edge. Depth maps: a smooth gradient
        per real view (zero maps in padded slots), and the same with the
        first `band_rows` source rows zeroed."""
        images, cams, plane_z = textured_plane_scene(
            n_views=n_src + 1, width=width, height=height,
            f=151.73 * width / 128.0, plane_z=5.1703)
        inputs = build_solver_inputs(images[0], images[1:], cams[0],
                                     cams[1:], params,
                                     num_views_pad=num_views_pad,
                                     device=dev)
        V, Hs, Ws = inputs.src_imgs.shape
        gy = torch.linspace(0.0, 0.3, Hs, device=dev)[:, None].expand(Hs, Ws)
        smooth = torch.zeros((V, Hs, Ws), device=dev)
        for v in range(n_src):
            smooth[v] = plane_z + (gy if v % 2 == 0 else -gy)
        band = smooth.clone()
        band[:n_src, :band_rows] = 0.0
        return inputs, plane_z, smooth, band

    def off_plane(inputs, plane_z, scales):
        """Fronto-parallel planes at plane_z x scale: generic fractional
        source coordinates, as in tests/test_pallas_geom.py."""
        H, W = inputs.ref_img.shape
        x, y = geo.pixel_grid(H, W, device=dev)
        cam = inputs.ref_cam
        n_world = torch.tensor([0.0, 0.0, -1.0], device=dev).expand(H, W, 3)
        n_cam = geo.normal_world_to_cam(cam, n_world)
        return torch.stack([geo.plane_from_depth_normal(
            cam, x, y, torch.full((H, W), plane_z * s, device=dev), n_cam)
            for s in scales])

    def compare_geom(inputs, depths, planes, off0, label, valid_from=None):
        """Kernel vs plain on the same inputs and vs its first design,
        bitwise (torch.equal, padded slots included); the JAX package's
        geom bar and, with `valid_from`, the geom_cost_max bands of the
        off-plane hypotheses (the first two) from that grid row on are
        logged beside it."""
        nv = int(inputs.view_mask.sum())
        if off0 is not None:
            planes = parity.pack_rows_c(planes, off0)
        planes = planes.contiguous()
        K = planes.shape[0]
        args = (inputs.ref_cam, inputs.src_cams, depths, planes)

        def run(p):
            return geom_ops.geom_consistency_cost(
                *args, p, row_pack_off=off0, n_views=nv)

        got = run(params)
        ref = run(plain_params)
        first = cuda_geom.geom_first_cuda(*args, params, row_pack_off=off0,
                                          n_views=nv)
        torch.cuda.synchronize()
        mx = params.geom_cost_max
        a, b = got[..., :nv], ref[..., :nv]
        assert torch.isfinite(got).all(), label
        d = (a - b).abs()
        bad = (d > GEOM_ATOL + GEOM_RTOL * b.abs()).float().mean().item()
        err = d.max().item()
        geom_err[K] = max(geom_err[K], err)
        pad_ok = bool((got[..., nv:] == mx).all()
                      and (ref[..., nv:] == mx).all())
        band_ok = True
        if valid_from is not None:
            band_ok = bool(torch.equal(a[:2, valid_from:] >= mx,
                                       b[:2, valid_from:] >= mx))
        eq_plain = bool(torch.equal(got, ref))
        eq_first = bool(torch.equal(got, first))
        log(f"  {label}: K={K} shape {tuple(got.shape)} == plain {eq_plain}"
            f" == first design {eq_first}; bad {bad:.2e} max|d| {err:.3e} "
            f"at max {(a >= mx).float().mean().item():.4f} padded-slot max "
            f"{pad_ok} bands equal {band_ok}")
        assert eq_plain and eq_first, label
        assert pad_ok and band_ok, label

    for width, height, n_src, vpad, band_rows, valid_from in (
            (320, 240, 4, 5, 16, 48), (800, 592, 8, None, 32, 80),
            (1600, 1184, 8, None, 64, 160)):
        log(f"phase 3c: geom kernel vs plain, {width}x{height}, {n_src} "
            f"sources" + (" (+1 padded slot)" if vpad else ""))
        rig, pz, smooth, band = geom_rig(width, height, n_src, band_rows,
                                         vpad)
        off = off_plane(rig, pz, (1.031, 0.967))
        rw = random_planes(rig, 3, 61, 0.125, 0.25)
        rx = random_planes(rig, 3, 62, 0.0, 0.0)
        stacks = {1: off[:1], 8: torch.cat([off, rw, rx]),
                  5: torch.cat([off, rw[:2], rx[:1]])}
        for depths, dname in ((smooth, "smooth"), (band, "band")):
            vf = valid_from if dname == "band" else 0
            compare_geom(rig, depths, stacks[1], None,
                         f"{dname} off-plane full", valid_from=vf)
            compare_geom(rig, depths, rw[:1], None,
                         f"{dname} random window+cap full")
            for K in (8, 5):
                for off0 in (0, 1):
                    compare_geom(rig, depths, stacks[K], off0,
                                 f"{dname} off0={off0}",
                                 valid_from=vf // 2)
        del rig, smooth, band, off, rw, rx, stacks

    # ---- phase 3f: batched launches against single-view launches ----
    mark("3f")
    batched_err = run_batched_kernels_phase(dev)

    # ---- phase 3d: the fusion sampler against its plain version ----
    mark("3d")
    from acmmp_tpu_torch.engine import fusion
    from acmmp_tpu_torch.ops import cuda_sample
    from acmmp_tpu_torch.ops import sample as sample_ops

    sample_err = {}
    rng = np.random.default_rng(3)
    on_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731

    def compare_sample(maps, rr, cc, valid, label):
        """Kernel vs plain on the same inputs: bitwise (int32 views, so a
        NaN word compares too)."""
        got = sample_ops.gather2d_sample(maps, rr, cc, valid)
        ref = sample_ops.gather2d_sample(maps, rr, cc, valid,
                                         backend="plain")
        torch.cuda.synchronize()
        same = bool(torch.equal(got.view(torch.int32),
                                ref.view(torch.int32)))
        err = torch.nan_to_num((got - ref).abs()).max().item()
        C = maps.shape[1]
        sample_err[C] = max(sample_err.get(C, 0.0), err)
        log(f"  {label}: maps {tuple(maps.shape)} out {tuple(got.shape)} "
            f"valid {valid.float().mean().item():.4f} bitwise {same}")
        assert same, label

    def case(V, C, Hs, Ws, H, W, valid_share, field):
        maps = rng.normal(size=(V, C, Hs, Ws)).astype(np.float32)
        if field == "coherent":
            y, x = np.mgrid[:H, :W]
            rr = np.clip((0.9 * y + 0.02 * x + 3).astype(np.int32), 0, Hs - 1)
            cc = np.clip((0.97 * x + 0.1 * y + 1).astype(np.int32), 0,
                         Ws - 1)
            rr = np.broadcast_to(rr, (V, H, W)).copy()
            cc = np.broadcast_to(cc, (V, H, W)).copy()
        else:
            rr = rng.integers(0, Hs, (V, H, W)).astype(np.int32)
            cc = rng.integers(0, Ws, (V, H, W)).astype(np.int32)
        valid = rng.random((V, H, W)) < valid_share
        rr[~valid] = np.int32(-2147483648)       # NaN-cast garbage
        cc[~valid] = np.int32(2147483647)
        return tuple(on_dev(a) for a in (maps, rr, cc, valid))

    log("phase 3d: sampler kernel vs plain, the cases of "
        "tests/test_pallas_sample.py")
    for label, args in (
            ("coherent field", (2, 3, 32, 128, 16, 128, 1.0, "coherent")),
            ("scattered indices", (2, 2, 40, 256, 8, 128, 1.0, "random")),
            ("invalid lanes, garbage indices",
             (1, 2, 24, 128, 8, 128, 0.7, "random")),
            ("all-invalid tile", (1, 1, 16, 128, 8, 128, 0.0, "random")),
            ("unaligned shapes", (2, 4, 21, 100, 13, 77, 0.9, "random"))):
        compare_sample(*case(*args), label)

    def fusion_fields(scene, C, seed, garbage_share):
        """Fusion's sampler inputs for view 0 of a 9-view scene: index
        fields from projecting a gently curved depth map into the 8
        sources (fusion._project_index; lanes projected out of view are
        invalid), `garbage_share` of the lanes also invalid with garbage
        indices, random maps with a NaN lattice (all 8 views x C channels
        at the sources' shape)."""
        images, cams, pz = scene
        H, W = images[0].shape
        ref = cams[0].to_torch(dev)
        src = geo.stack_cameras([c.to_torch(dev) for c in cams[1:]])
        x, y = geo.pixel_grid(H, W, device=dev)
        depth = pz * (1.0 + 0.01 * torch.sin(x / 37.0) * torch.cos(y / 23.0))
        Xw = geo.world_point(ref, x, y, depth)
        rr, cc, inb = fusion._project_index(fusion._per_view(src), Xw, H, W)
        V = rr.shape[0]
        bad = on_dev(rng.random((V, H, W)) < garbage_share)
        garbage = on_dev(rng.integers(-2 ** 31, 2 ** 31 - 1, (2, V, H, W),
                                      dtype=np.int64).astype(np.int32))
        rr = torch.where(bad, garbage[0], rr).contiguous()
        cc = torch.where(bad, garbage[1], cc).contiguous()
        gen = torch.Generator(device=dev).manual_seed(seed)
        maps = torch.randn((V, C, H, W), generator=gen, device=dev)
        maps[..., ::97, ::89] = float("nan")
        return maps, rr, cc, (inb & ~bad).contiguous()

    for (width, height), scene_ in chain_scenes.items():
        for C in SAMPLE_CHANNELS:
            log(f"phase 3d: sampler kernel vs plain at fusion's shape, "
                f"{width}x{height}, 8 views, C={C}")
            compare_sample(*fusion_fields(scene_, C, 80 + C,
                                          SAMPLE_INVALID_SHARE),
                           "projected field, 10% garbage lanes")

    # ---- phase 4: solve-level, kernel vs plain, same key ----
    mark("4")
    log("phase 4: 320x240 solve, kernel vs plain, same key")
    small4, _, _ = scene(320, 240, 4)
    (share, share5), (noise, noise5), dk = solve_agreement(small4, params,
                                                           keys.key(7))
    err4 = (dk - plane_z).abs().median().item()
    log(f"  interior depths within {SOLVE_REL_TOL:.0%}: {share:.4f} (bar "
        f"{SOLVE_MIN_SHARE}); within 5%: {share5:.4f}; the plain solve "
        f"against itself under 1e-5 cost noise: {noise:.4f} and "
        f"{noise5:.4f}; median |depth - z| kernel {err4:.4f}")
    assert share >= SOLVE_MIN_SHARE, share

    # ---- phase 5: the main path at full width ----
    mark("5")
    def full_width_solve(inputs, kparams, plane):
        """The 1600x1184 / 8-source solve through the kernel, warm-up then
        timed with the launch counts reset just before; returns the
        launches of the instantiation it ran (those of the other must be
        0)."""
        f32 = not kparams.ncc_src_u8
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        run_patchmatch(inputs, keys.key(1), kparams, Mode())   # warm-up
        torch.cuda.synchronize()
        cuda_ncc.reset_launch_counts()
        cuda_geom.reset_launch_counts()
        ev0.record()
        t_host = time.perf_counter()
        out = run_patchmatch(inputs, keys.key(2), kparams, Mode())
        ev1.record()
        torch.cuda.synchronize()
        t_host = time.perf_counter() - t_host
        counts = dict(cuda_ncc.launches_f32 if f32 else cuda_ncc.launches)
        other = cuda_ncc.launches if f32 else cuda_ncc.launches_f32
        assert cuda_geom.total_launches() == 0
        assert sum(other.values()) == 0, other
        solve_ms = ev0.elapsed_time(ev1)
        log(f"  launches {counts} (want {want_solve}); solve "
            f"{solve_ms:.1f} ms device-clock, {t_host * 1e3:.1f} ms "
            f"host-clock; {1e3 / solve_ms:.3f} maps/s")
        assert counts == want_solve, counts
        assert sum(counts.values()) == 13
        r0, r1 = int(0.2 * h_big), int(0.8 * h_big)
        c0, c1 = int(0.19 * w_big), int(0.81 * w_big)
        depth = out.depth[r0:r1, c0:c1]
        assert torch.isfinite(out.depth).all()
        assert tuple(out.depth.shape) == tuple(inputs.ref_img.shape)
        err = (depth - plane).abs()
        med = err.median().item()
        log(f"  median interior |depth - z| {med:.4f} (bar 0.15); "
            f"share < 0.5: {(err < 0.5).float().mean().item():.4f}")
        assert med < 0.15, med
        return counts

    log("phase 5: 1600x1184, 8 sources, PatchMatchParams(), Mode()")
    counts = full_width_solve(big, params, plane_z_big)
    # this slice's path: the same solve on float sources, through the
    # kernel's float-source instantiation
    log("phase 5b: 1600x1184, 8 sources, PatchMatchParams(ncc_src_u8=False)"
        ", Mode()")
    counts_f32 = full_width_solve(big_f, f_params, plane_z_big_f)

    # ---- phase 5c: the batched photometric solve at full width ----
    mark("5c")
    batched_table, _ = run_batched_solve_phase(
        {f"{w}x{h}": sc for (w, h), sc in chain_scenes.items()}, dev)

    # ---- phase 6: per-launch times beside the plain version and bound ----
    mark("6")
    def bound(inputs, K, Hg, W, src_bytes):
        """(bound ms, what bounds it, tap evaluations) of one ZNCC launch:
        the FP32 operations at the FP32 peak, or the bytes it must move
        (planes, `src_bytes` per source pixel, tap weights, reference sums
        and costs) at the memory rate."""
        V, Hs, Ws = inputs.src_imgs.shape
        nv = int(inputs.view_mask.sum())
        T = len(params.tap_offsets) ** 2
        evals = K * nv * T * Hg * W
        nbytes = (K * Hg * W * 16 + src_bytes * nv * Hs * Ws
                  + 2 * T * Hg * W * 4 + 3 * Hg * W * 4 + K * Hg * W * V * 4)
        t_ops = evals * OPS_PER_TAP_EVAL / PEAK_FP32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        return (max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes", evals)

    log("phase 6: per-launch times (CUDA events)")
    zregs = ptxas_registers(_build.BUILD_LOG.get("zncc", ""))
    T = len(params.tap_offsets) ** 2
    # (source type, its template argument in the mangled name)
    src_kinds = (("u8", "j"), ("f32", "6float4"))
    # each K and source type in its instantiation for one view and for a
    # batch (the template's last argument)
    for kind, tag in src_kinds:
        for K in cuda_ncc.SUPPORTED_K:
            for batched in (False, True):
                blocks, threads = cuda_ncc.occupancy(K, T, kind, batched)
                (r,) = [v for n, v in zregs.items()
                        if f"zncc_kernelILi{K}E{tag}Lb{int(batched)}E" in n]
                log(f"  zncc.cu K={K}, {kind} sources"
                    f"{', batched' if batched else ''}: {r} registers "
                    f"(ptxas), {blocks} blocks of {threads} threads = "
                    f"{blocks * threads // 32} warps per SM (occupancy "
                    f"calculator, {T} taps)")
                # the design's register budget; the first design held 12
                # warps per SM at K=8
                assert r <= 64, (K, kind, batched, r)
                assert K != 8 or blocks * threads // 32 >= 24, (
                    blocks, threads)
    rows, table = [], {}
    # (label, inputs, params, source bytes per pixel the bound counts: the
    # 8-bit pixel, or the float source's 16-byte quad the kernel reads)
    for label, inputs, kparams, src_bytes in (
            ("320x240", small4, params, 1), ("1600x1184", big, params, 1),
            ("320x240", small4_f, f_params, 16),
            ("1600x1184", big_f, f_params, 16)):
        kind = cuda_ncc.source_type(kparams)
        pparams = dataclasses.replace(kparams, ncc_backend="plain")
        vg = ncc_ops.make_view_geometry(inputs.ref_cam, inputs.src_cams)
        nv = int(inputs.view_mask.sum())
        H, W = inputs.ref_img.shape
        preps = {None: cuda_ncc.prepare(inputs.ref_img, inputs.src_imgs, vg,
                                        kparams, None)}
        preps[0] = cuda_ncc.prepare(inputs.ref_img, inputs.src_imgs, vg,
                                    kparams, 0, shared=preps[None])
        for K in (1, 8, 3, 2):
            off0 = None if K == 1 else 0
            Hg = H if off0 is None else H // 2
            planes = random_planes(inputs, K, 40 + K, 0.125, 0.25)
            if off0 is not None:
                planes = parity.pack_rows_c(planes, off0).contiguous()

            def kern():
                return cuda_ncc.multiview_zncc_cuda(
                    inputs.ref_img, inputs.src_imgs, vg, planes, kparams,
                    row_pack_off=off0, n_views=nv, prep=preps[off0])

            def plain():
                if off0 is None:
                    return ncc_ops.multiview_zncc(
                        inputs.ref_img, inputs.src_imgs, vg, planes,
                        pparams)
                return ncc_ops.multiview_zncc_packed(
                    inputs.ref_img, inputs.src_imgs, vg, planes,
                    pparams, off0)

            ms = time_ms(kern, 20)
            plain_ms = time_ms(plain, 2)
            b_ms, b_by, evals = bound(inputs, K, Hg, W, src_bytes)
            table[(label, kind, K)] = (ms, plain_ms, b_ms, b_by)
            log(f"  {label} K={K} {kind} sources grid {Hg}x{W} views {nv}: "
                f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}), "
                f"{evals / (ms * 1e-3) / 1e9:.2f} G tap-evals/s")
            if label == "1600x1184" and K == 8 and kind == "u8":
                # the field of phase 9's second decomposition (same key)
                aprep = cuda_ablate.prepare(inputs.ref_img, inputs.src_imgs,
                                            vg, params, off0)
                ab_time("phase 6 random field, 1600x1184",
                        lambda: cuda_ablate.ablate_cuda("full", planes, aprep,
                                                        params, nv), kern,
                        ratio_bar=ZNCC_U8_RATIO_PR5["random"]
                        * ZNCC_U8_RATIO_SLACK)
                del aprep
        del preps
    del small4_f, big_f

    def geom_bound(inputs, K, Hg, W):
        V, Hs, Ws = inputs.src_imgs.shape
        nv = int(inputs.view_mask.sum())
        ops = (K * GEOM_OPS_PER_EVAL + GEOM_OPS_PER_PIXEL_VIEW) * nv * Hg * W
        nbytes = K * Hg * W * 16 + nv * Hs * Ws * 4 + K * Hg * W * V * 4
        t_ops = ops / PEAK_FP32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        return (max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    gregs = ptxas_registers(_build.BUILD_LOG.get("geom", ""))
    for fn_name, r in sorted(gregs.items()):
        log(f"  geom.cu {fn_name}: {r} registers (ptxas)")
    for V in (5, 8):
        for batched in (False, True):
            blocks, threads = cuda_geom.occupancy(V, batched)
            name = f"geom_kernelILb{int(V % 4 == 0)}ELb{int(batched)}E"
            (r,) = [v for n, v in gregs.items() if name in n]
            log(f"  geom.cu, V={V}{', batched' if batched else ''}: {r} "
                f"registers (ptxas), {blocks} blocks of {threads} threads "
                f"= {blocks * threads // 32} warps per SM (occupancy "
                f"calculator)")
            # its __launch_bounds__: 8 blocks of 128 threads, 64 registers
            assert r <= 64 and blocks >= 8, (V, batched, r, blocks)
    geom_table, geom_first_ms = {}, {}
    for (width, height), (images, cams, pz) in chain_scenes.items():
        label = f"{width}x{height}"
        inputs = build_solver_inputs(
            images[0], images[1:], cams[0], cams[1:], params, device=dev,
            src_depths=[np.full(im.shape, pz, np.float32)
                        for im in images[1:]])
        nv = int(inputs.view_mask.sum())
        H, W = inputs.ref_img.shape
        gprep = cuda_geom.prepare(inputs.ref_cam, inputs.src_cams,
                                  inputs.src_depths)
        for K in (1, 8, 5):
            off0 = None if K == 1 else 0
            Hg = H if off0 is None else H // 2
            # coherent candidates, as a geometric solve scores them
            planes = true_planes(inputs, pz, K, 70 + K)
            if off0 is not None:
                planes = parity.pack_rows_c(planes, off0).contiguous()
            gargs = (inputs.ref_cam, inputs.src_cams, inputs.src_depths,
                     planes)

            def gkern():
                return cuda_geom.geom_consistency_cost_cuda(
                    *gargs, params, row_pack_off=off0, n_views=nv,
                    prep=gprep)

            def gfirst():
                return cuda_geom.geom_first_cuda(
                    *gargs, params, row_pack_off=off0, n_views=nv,
                    prep=gprep)

            def gplain():
                return geom_ops.geom_consistency_cost(
                    *gargs, plain_params, row_pack_off=off0)

            ms = time_ms(gkern, 20)
            plain_ms = time_ms(gplain, 2)
            b_ms, b_by = geom_bound(inputs, K, Hg, W)
            geom_table[(label, K)] = (ms, plain_ms, b_ms, b_by)
            log(f"  geom {label} K={K} grid {Hg}x{W} views {nv}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
                f"({b_by}), {K * nv * Hg * W / (ms * 1e-3) / 1e9:.2f} G "
                f"evals/s")
            # the redesign must beat its first design where a geometric
            # solve spends most launches (K=8 and K=5)
            geom_first_ms[(label, K)], _ = ab_time(
                f"{label}", gfirst, gkern, what=f"geom.cu K={K}",
                must_beat=K != 1)
        del inputs, gprep, planes

    sample_table = {}
    for (width, height), scene_ in chain_scenes.items():
        for C in SAMPLE_CHANNELS:
            # fusion's own invalid lanes only (projected out of view)
            maps, rr, cc, valid = fusion_fields(scene_, C, 90 + C, 0.0)
            V, _, Hs, Ws = maps.shape
            H, W = rr.shape[1:]

            def skern():
                return cuda_sample.gather2d_cuda(maps, rr, cc, valid)

            def splain():
                return sample_ops.gather2d(maps, rr, cc, valid)

            def slib():
                # the yardstick: one torch.gather on the flattened maps
                # with the masked index, then torch.where
                idx = torch.where(valid, rr.long() * Ws + cc.long(), 0)
                out = torch.gather(maps.reshape(V, C, Hs * Ws), 2,
                                   idx.reshape(V, 1, H * W).expand(
                                       V, C, H * W))
                return torch.where(valid[:, None],
                                   out.reshape(V, C, H, W), 0.0)

            ms = time_ms(skern, 20)
            plain_ms = time_ms(splain, 5)
            lib_ms = time_ms(slib, 5)
            # no arithmetic: the bytes these inputs need bound it
            nbytes = sample_bytes(maps, rr, cc, valid).item()
            b_ms, b_by = nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"
            label = f"{width}x{height}"
            sample_table[(label, C)] = (ms, plain_ms, b_ms, b_by, lib_ms)
            log(f"  sample {label} C={C} views {V}: valid lanes "
                f"{valid.float().mean().item():.4f}, {nbytes} bytes to move; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.gather "
                f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                f"{b_ms / ms:.3f} of it")
            del maps, rr, cc, valid

    # ---- phase 9: the ZNCC cost decomposition and the lane probes ----
    mark("9")
    # phase 6's random K = 8 field at 1600x1184 (same key), packed
    random8 = parity.pack_rows_c(random_planes(big, 8, 48, 0.125, 0.25),
                                 0).contiguous()
    ablation_rows = run_ablation_phase(dev, big, random8)
    del random8

    # ---- phase 7: the per-view two-scale chain at full width ----
    mark("7")
    chain = run_chain({size: ([images[i] for i in CHAIN_VIEWS],
                              [cams[i] for i in CHAIN_VIEWS], pz)
                       for size, (images, cams, pz) in chain_scenes.items()},
                      dev, card)
    geom_counts = chain["geom_launches"]

    # ---- phase 8: the pipeline at full width through the disk ----
    mark("8")
    fine_scene = chain_scenes[(1600, 1184)]
    log(f"phase 8: run_pipeline on a {len(fine_scene[0])}-view 1600x1184 "
        f"dense folder, PipelineConfig(), texture scale "
        f"{CHAIN_TEXTURE_SCALE}")
    ref_err = photometric_yardstick(fine_scene, dev)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    pipe = run_pipeline_phase(fine_scene, dev, work, ref_err)
    # ---- phase 8b: the same folder through the batched executor ----
    mark("8b")
    log(f"phase 8b: run_pipeline on a dense folder of views 0-"
        f"{PHASE8B_VIEWS - 1} of phase 8's scene, "
        f"PipelineConfig(view_batch=4)")
    scene_b = (fine_scene[0][:PHASE8B_VIEWS], fine_scene[1][:PHASE8B_VIEWS],
               fine_scene[2])
    dense_b = write_dense_folder(os.path.join(work, "dense_b"),
                                 *scene_b[:2])
    pipe_b = run_batched_pipeline_phase(dense_b, scene_b, dev, pipe)
    # ---- phase 11c: the same folder over a view mesh on this card ----
    mark("11c")
    log(f"phase 11c: run_pipeline on phase 8's dense folder over a view "
        f"mesh of {MESH_MEMBERS} members on {dev}, PipelineConfig("
        f"planar_prior_max_pixels={PHASE11C_PRIOR_MAX_PIXELS})")
    run_mesh_pipeline_phase(pipe["dense"], fine_scene, dev, pipe)
    shutil.rmtree(pipe["dense"])
    # ---- phase 12: two processes on this card, one global mesh ----
    mark("12")
    log(f"phase 12: {PHASE12_RANKS} processes of `acmmp_tpu_torch.cli "
        f"reconstruct --mesh` on {dev} (views 0-{PHASE8B_VIEWS - 1}, "
        f"planar_prior_max_pixels={PHASE11C_PRIOR_MAX_PIXELS}) against "
        f"run_pipeline over a single-process mesh of {PHASE12_RANKS} "
        f"members")
    run_multiprocess_phase(dense_b, scene_b, dev, pipe)
    # ---- phase 10: the rest of the CLI and the DTU method grid ----
    mark("10")
    run_dtu_grid_phase(work, dev)
    # ---- phase 10b: full-scale quality ----
    mark("10b")
    run_fullscale_phase(work, dev)
    shutil.rmtree(work)
    # ---- phase 11a: geom.cu and zncc.cu at a tile origin ----
    mark("11a")
    log(f"phase 11a: geom.cu at tile origins {TILE_ORIGIN} and (0, 0) "
        f"against plain, 1600x1184, 8 sources (phase 3c's rig)")
    rig, pz, smooth, _band = geom_rig(1600, 1184, 8, 64)
    nv = int(rig.view_mask.sum())
    off = off_plane(rig, pz, (1.031, 0.967))
    rw = random_planes(rig, 6, 113, 0.125, 0.25)
    stacks = {1: rw[:1], 8: torch.cat([off, rw]),
              5: torch.cat([off, rw[:3]])}
    for origin in (TILE_ORIGIN, (0, 0)):
        for K, off0 in ((1, None), (8, 0), (8, 1), (5, 0), (5, 1)):
            pk = (stacks[K] if off0 is None
                  else parity.pack_rows_c(stacks[K], off0)).contiguous()
            gargs = (rig.ref_cam, rig.src_cams, smooth, pk)
            got = geom_ops.geom_consistency_cost(
                *gargs, params, row_pack_off=off0, n_views=nv, origin=origin)
            want_g = geom_ops.geom_consistency_cost(
                *gargs, plain_params, row_pack_off=off0, origin=origin)
            eq = bool(torch.equal(got, want_g))
            line = (f"  origin {origin} K={K} off0={off0}: == plain {eq}; at "
                    f"max {(got >= params.geom_cost_max).float().mean().item():.4f}")
            if origin == (0, 0):
                # the bits before the origin: the frozen first design's
                first = cuda_geom.geom_first_cuda(
                    *gargs, params, row_pack_off=off0, n_views=nv)
                same = bool(torch.equal(got, first))
                line += f"; == first design {same}"
                assert same, (origin, K, off0)
            log(line)
            assert eq, (origin, K, off0)
    del rig, smooth, _band, off, rw, stacks
    # K=8 at the tile origin and at (0, 0) in turns, on phase 6's field
    images_f, cams_f, pz_f = chain_scenes[(1600, 1184)]
    tin = build_solver_inputs(
        images_f[0], images_f[1:], cams_f[0], cams_f[1:], params, device=dev,
        src_depths=[np.full(im.shape, pz_f, np.float32)
                    for im in images_f[1:]])
    nv = int(tin.view_mask.sum())
    gprep = cuda_geom.prepare(tin.ref_cam, tin.src_cams, tin.src_depths)
    pk = parity.pack_rows_c(true_planes(tin, pz_f, 8, 78), 0).contiguous()
    gargs = (tin.ref_cam, tin.src_cams, tin.src_depths, pk)

    def gorigin(origin):
        return lambda: cuda_geom.geom_consistency_cost_cuda(
            *gargs, params, row_pack_off=0, n_views=nv, prep=gprep,
            origin=origin)

    turns = {(0, 0): [], TILE_ORIGIN: []}
    for origin in ((0, 0), TILE_ORIGIN, TILE_ORIGIN, (0, 0)):
        turns[origin].append(time_ms(gorigin(origin), 20))
    plain_origin_ms = time_ms(lambda: geom_ops.geom_consistency_cost(
        *gargs, plain_params, row_pack_off=0, origin=TILE_ORIGIN), 2)
    H_f, W_f = tin.ref_img.shape
    gb_ms, gb_by = geom_bound(tin, 8, H_f // 2, W_f)
    origin_ms = statistics.mean(turns[TILE_ORIGIN])
    log(f"  geom.cu K=8 packed, 1600x1184, in turns ((0, 0), origin, "
        f"origin, (0, 0)): origin {TILE_ORIGIN} {turns[TILE_ORIGIN]} ms, "
        f"(0, 0) {turns[(0, 0)]} ms; plain at the origin "
        f"{plain_origin_ms:.3f} ms; bound {gb_ms:.4f} ms ({gb_by})")
    del tin, gprep, pk, gargs
    log(f"phase 11a: zncc.cu at tile origin {TILE_ORIGIN} against plain, "
        f"1600x1184, 8 sources")
    compare(big, random_planes(big, 1, 114, 0.125, 0.25), None,
            f"random window+cap full, origin {TILE_ORIGIN}",
            origin=TILE_ORIGIN)
    compare(big, true_planes(big, plane_z_big, 8, 115), 0,
            f"coherent off0=0, origin {TILE_ORIGIN}", origin=TILE_ORIGIN)
    # ---- phase 11b: a view above tile_pixels over a tile mesh ----
    mark("11b")
    log(f"phase 11b: tile_sharded_patchmatch, {TILE_SHAPE[0]}x"
        f"{TILE_SHAPE[1]}, {TILE_SHAPE[2]} sources, {MESH_MEMBERS} members "
        f"on {dev}, PatchMatchParams()")
    tile = run_tile_phase(dev)
    n_sweeps = 2 * params.max_iterations
    n_views = len(fine_scene[0])
    # per view and scale: a first solve, its planar-prior second solve and
    # two geometric solves; 13 ZNCC launches per solve, 9 geom launches per
    # geometric solve, one sampler launch per fused view
    solves, geom_solves = 8 * n_views, 4 * n_views
    want = {"zncc": {1: solves, 8: solves * n_sweeps, 3: solves * n_sweeps,
                     2: solves * n_sweeps},
            "geom": {1: geom_solves, 8: geom_solves * n_sweeps,
                     5: geom_solves * n_sweeps},
            "sample": {"gather2d": n_views}}
    assert pipe["launches"] == want, (pipe["launches"], want)
    assert pipe["dual_launches"] == 2 * n_views, pipe["dual_launches"]

    for kind, launched, errs in (("u8", counts, max_err),
                                 ("f32", counts_f32, max_err_f32)):
        for K in (1, 8, 3, 2):
            ms, plain_ms, b_ms, b_by = table[("1600x1184", kind, K)]
            rows.append({
                "name": f"zncc_k{K}" if kind == "u8" else f"zncc_f32_k{K}",
                "route": "cuda", "source": "acmmp_tpu_torch/csrc/zncc.cu",
                "replaces": TPU_KERNEL[K], "launches": launched[K],
                "max_abs_err": errs[K], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    for K in (1, 8, 5):
        ms, plain_ms, b_ms, b_by = geom_table[("1600x1184", K)]
        rows.append({
            "name": f"geom_k{K}", "route": "cuda",
            "source": "acmmp_tpu_torch/csrc/geom.cu",
            "replaces": GEOM_TPU_KERNEL, "launches": geom_counts[K],
            "max_abs_err": geom_err[K], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    for C, launches in ((4, pipe["launches"]["sample"]["gather2d"]),
                        (8, pipe["dual_launches"])):
        ms, plain_ms, b_ms, b_by, lib_ms = sample_table[("1600x1184", C)]
        rows.append({
            "name": f"gather2d_c{C}", "route": "cuda",
            "source": "acmmp_tpu_torch/csrc/sample.cu",
            "replaces": SAMPLE_TPU_KERNEL, "launches": launches,
            "max_abs_err": sample_err[C], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
    # the batched launches (phase 5c's B = 4 times, phase 8b's launches)
    for kernel, K in (("zncc", 1), ("zncc", 8), ("zncc", 3), ("zncc", 2),
                      ("geom", 1), ("geom", 8), ("geom", 5)):
        ms, plain_ms, b_ms, b_by = batched_table[(kernel, K)]
        rows.append({
            "name": f"{kernel}_k{K}_batched", "route": "cuda",
            "source": f"acmmp_tpu_torch/csrc/{kernel}.cu",
            "replaces": TPU_KERNEL[K] if kernel == "zncc"
            else GEOM_TPU_KERNEL,
            "launches": pipe_b["launches"][kernel][K],
            "max_abs_err": batched_err[("u8" if kernel == "zncc" else kernel,
                                        K)],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None})
    # geom.cu at the tile origin: launches of phase 11b's tiled geometric
    # solve, all at origins of their members' grids
    rows.append({
        "name": "geom_k8_origin", "route": "cuda",
        "source": "acmmp_tpu_torch/csrc/geom.cu",
        "replaces": GEOM_TPU_KERNEL,
        "launches": tile["launches"]["geometric"]["geom"][8],
        "max_abs_err": 0.0, "ms": origin_ms, "plain_ms": plain_origin_ms,
        "bound_ms": gb_ms, "bound_by": gb_by, "library_ms": None})
    rows += ablation_rows
    assert all(math.isfinite(r["ms"]) for r in rows)
    end = time.perf_counter()
    log(f"chip_smoke wall {end - t_script:.1f} s; walls by phase (s): "
        f"{phase_walls(end)}")

    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
