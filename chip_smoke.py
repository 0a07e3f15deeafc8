#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (acmmp_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
  3. hold the ZNCC kernel against its plain PyTorch version on the card,
     on the 320x240 / 4-source bench scene: K=1 on the full grid, K=8/3/2
     on the parity-packed grid, coherent and random planes under both
     random laws, a padded view slot, and K-stacks bitwise equal to K
     separate K=1 launches; then again at the main path's own shapes
     (1600x1184, 8 sources);
  4. a full 320x240 solve through the kernel and through the plain
     version with the same key; report the depth agreement;
  5. the main path: the 1600x1184 / 8-source photometric solve with the
     shipping PatchMatchParams(), warm-up then timed; 13 kernel launches
     per solve; median interior depth error below 0.15;
  6. per-launch kernel times at both shapes beside the plain version and
     the bound, as one JSON line; then the card line and the result line.

Imports nothing of JAX. Exits non-zero without a result when there is no
CUDA device or when the acmmp_tpu_torch package is not beside it.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

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

TPU_KERNEL = {1: "acmmp_tpu/ops/pallas_ncc.py:108",
              2: "acmmp_tpu/ops/pallas_ncc.py:542",
              3: "acmmp_tpu/ops/pallas_ncc.py:542",
              8: "acmmp_tpu/ops/pallas_ncc.py:542"}


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    log(f"card: {card}")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    from acmmp_tpu_torch.config import PatchMatchParams
    from acmmp_tpu_torch.core import geometry as geo
    from acmmp_tpu_torch.engine.inputs import build_solver_inputs
    from acmmp_tpu_torch.engine.patchmatch import Mode, run_patchmatch
    from acmmp_tpu_torch.kernels import _build
    from acmmp_tpu_torch.ops import cuda_ncc, keys
    from acmmp_tpu_torch.ops import ncc as ncc_ops
    from acmmp_tpu_torch.ops import parity, sampling
    from acmmp_tpu_torch.utils.synth import textured_plane_scene

    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- phase 2: build ----
    t0 = time.perf_counter()
    names = _build.all_kernels()
    _build.build(names)
    log(f"phase 2: built {names} in {time.perf_counter() - t0:.2f} s")
    for name, text in _build.BUILD_LOG.items():
        log(f"nvcc {name}:\n{text.strip()}")

    params = PatchMatchParams()
    plain_params = PatchMatchParams(ncc_backend="plain")

    def scene(width, height, n_src, num_views_pad=None):
        images, cams, plane_z = textured_plane_scene(
            n_views=n_src + 1, width=width, height=height,
            f=600.0 * width / 320.0, plane_z=5.0)
        inputs = build_solver_inputs(images[0], images[1:], cams[0],
                                     cams[1:], params,
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

    def compare(inputs, planes, off0, label, origin=None):
        """Kernel vs plain on the same inputs; K-stack vs K=1 launches."""
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

        got = run(params, pk)
        ref = run(plain_params, pk)
        torch.cuda.synchronize()
        a, b = got[..., :nv], ref[..., :nv]
        assert torch.isfinite(got).all(), label
        d = (a - b).abs()
        bad = (d > ZNCC_ATOL + ZNCC_RTOL * b.abs()).float().mean().item()
        err = d.max().item()
        max_err[K] = max(max_err[K], err)
        pad_ok = bool((got[..., nv:] == params.cost_max).all())
        singles = [run(params, pk[k:k + 1].contiguous()) for k in range(K)]
        bitwise = bool(torch.equal(torch.cat(singles), got))
        log(f"  {label}: K={K} shape {tuple(got.shape)} bad {bad:.2e} "
            f"max|d| {err:.3e} padded-slot cost_max {pad_ok} "
            f"K-stack==K x K=1 {bitwise}")
        assert bad < ZNCC_MAX_FRAC, (label, bad)
        assert pad_ok, label
        assert bitwise, label

    # ---- phase 3: kernel against plain ----
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

    log("phase 3b: kernel vs plain at the main path's shapes, "
        "1600x1184, 8 sources")
    big, plane_z_big, (h_big, w_big) = scene(1600, 1184, 8)
    compare(big, random_planes(big, 1, 31, 0.125, 0.25), None,
            "init random window+cap")
    for K in (8, 3, 2):
        compare(big, true_planes(big, plane_z_big, K, 50 + K), 0,
                "coherent off0=0")
    compare(big, random_planes(big, 2, 32, 0.125, 0.25), 1,
            "random window+cap off0=1")

    # ---- phase 4: solve-level, kernel vs plain, same key ----
    log("phase 4: 320x240 solve, kernel vs plain, same key")
    small4, _, (h4, w4) = scene(320, 240, 4)
    key = keys.key(7)
    out_k = run_patchmatch(small4, key, params, Mode())
    out_p = run_patchmatch(small4, key, plain_params, Mode())
    torch.cuda.synchronize()
    r0, r1 = int(0.2 * h4), int(0.8 * h4)
    c0, c1 = int(0.19 * w4), int(0.81 * w4)
    dk = out_k.depth[r0:r1, c0:c1]
    dp = out_p.depth[r0:r1, c0:c1]
    rel = ((dk - dp).abs() / dp.abs())
    share = (rel < SOLVE_REL_TOL).float().mean().item()
    share5 = (rel < 0.05).float().mean().item()
    err4 = (dk - plane_z).abs().median().item()
    log(f"  interior depths within {SOLVE_REL_TOL:.0%}: {share:.4f} (bar "
        f"{SOLVE_MIN_SHARE}); within 5%: {share5:.4f}; "
        f"median |depth - z| kernel {err4:.4f}")
    assert share >= SOLVE_MIN_SHARE, share

    # ---- phase 5: the main path at full width ----
    log("phase 5: 1600x1184, 8 sources, PatchMatchParams(), Mode()")
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    run_patchmatch(big, keys.key(1), params, Mode())       # warm-up
    torch.cuda.synchronize()
    cuda_ncc.reset_launch_counts()
    ev0.record()
    t_host = time.perf_counter()
    out = run_patchmatch(big, keys.key(2), params, Mode())
    ev1.record()
    torch.cuda.synchronize()
    t_host = time.perf_counter() - t_host
    counts = dict(cuda_ncc.launches)
    solve_ms = ev0.elapsed_time(ev1)
    n_sweeps = 2 * params.max_iterations
    want = {1: 1, 8: n_sweeps, 3: n_sweeps, 2: n_sweeps}
    log(f"  launches {counts} (want {want}); solve {solve_ms:.1f} ms "
        f"device-clock, {t_host * 1e3:.1f} ms host-clock; "
        f"{1e3 / solve_ms:.3f} maps/s")
    assert counts == want, counts
    assert sum(counts.values()) == 13
    r0, r1 = int(0.2 * h_big), int(0.8 * h_big)
    c0, c1 = int(0.19 * w_big), int(0.81 * w_big)
    depth = out.depth[r0:r1, c0:c1]
    assert torch.isfinite(out.depth).all()
    assert tuple(out.depth.shape) == tuple(big.ref_img.shape)
    err = (depth - plane_z_big).abs()
    med = err.median().item()
    log(f"  median interior |depth - z| {med:.4f} (bar 0.15); "
        f"share < 0.5: {(err < 0.5).float().mean().item():.4f}")
    assert med < 0.15, med

    # ---- phase 6: per-launch times beside the plain version and bound ----
    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def bound(inputs, K, Hg, W):
        V, Hs, Ws = inputs.src_imgs.shape
        nv = int(inputs.view_mask.sum())
        T = len(params.tap_offsets) ** 2
        evals = K * nv * T * Hg * W
        nbytes = (K * Hg * W * 16 + nv * Hs * Ws + 2 * T * Hg * W * 4
                  + 3 * Hg * W * 4 + K * Hg * W * V * 4)
        t_ops = evals * OPS_PER_TAP_EVAL / PEAK_FP32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        return (max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes", evals)

    log("phase 6: per-launch times (CUDA events)")
    rows, table = [], {}
    for label, inputs in (("320x240", small4), ("1600x1184", big)):
        vg = ncc_ops.make_view_geometry(inputs.ref_cam, inputs.src_cams)
        nv = int(inputs.view_mask.sum())
        H, W = inputs.ref_img.shape
        preps = {None: cuda_ncc.prepare(inputs.ref_img, inputs.src_imgs, vg,
                                        params, None),
                 0: cuda_ncc.prepare(inputs.ref_img, inputs.src_imgs, vg,
                                     params, 0)}
        for K in (1, 8, 3, 2):
            off0 = None if K == 1 else 0
            Hg = H if off0 is None else H // 2
            planes = random_planes(inputs, K, 40 + K, 0.125, 0.25)
            if off0 is not None:
                planes = parity.pack_rows_c(planes, off0).contiguous()

            def kern():
                return cuda_ncc.multiview_zncc_cuda(
                    inputs.ref_img, inputs.src_imgs, vg, planes, params,
                    row_pack_off=off0, n_views=nv, prep=preps[off0])

            def plain():
                if off0 is None:
                    return ncc_ops.multiview_zncc(
                        inputs.ref_img, inputs.src_imgs, vg, planes,
                        plain_params)
                return ncc_ops.multiview_zncc_packed(
                    inputs.ref_img, inputs.src_imgs, vg, planes,
                    plain_params, off0)

            ms = time_ms(kern, 20)
            plain_ms = time_ms(plain, 2)
            b_ms, b_by, evals = bound(inputs, K, Hg, W)
            table[(label, K)] = (ms, plain_ms, b_ms, b_by)
            log(f"  {label} K={K} grid {Hg}x{W} views {nv}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
                f"({b_by}), {evals / (ms * 1e-3) / 1e9:.2f} G tap-evals/s")
    for K in (1, 8, 3, 2):
        ms, plain_ms, b_ms, b_by = table[("1600x1184", K)]
        rows.append({
            "name": f"zncc_k{K}", "route": "cuda",
            "source": "acmmp_tpu_torch/csrc/zncc.cu",
            "replaces": TPU_KERNEL[K], "launches": counts[K],
            "max_abs_err": max_err[K], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    assert all(math.isfinite(r["ms"]) for r in rows)

    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
