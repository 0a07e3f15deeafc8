#!/usr/bin/env python3
"""Conditioning of the f32 ZNCC on a GPU: the port's centred moments
against the uncentred one-pass form the JAX package uses.

    python3 tools/torch_zncc_conditioning.py

For the bench scene at 320x240 (4 sources) and the DTU operating point
1600x1184 (8 sources), with coherent (true-plane) and random hypothesis
fields, it scores one K=1 field four ways on the card:
  * the CUDA kernel (centred, f32),
  * the plain PyTorch version (centred, f32),
  * the uncentred one-pass form of the JAX oracle (f32, written below),
  * the plain version in float64 — the yardstick,
and prints, per f32 evaluation, the share of costs that miss the f64
yardstick by more than the ZNCC bar (2e-3 + 1e-3 |f64|). Needs a CUDA
device; imports nothing of JAX."""

from __future__ import annotations

import os
import sys

import torch


def uncentred_zncc(ref_img, src_imgs, vg, planes, params, ncc_ops, geo):
    """The JAX oracle's arithmetic (acmmp_tpu/ops/ncc.py _zncc_grids):
    moments of the raw values."""
    H, W = ref_img.shape
    x, y = geo.pixel_grid(H, W, device=ref_img.device)
    m = geo.matvec(vg.KrT, planes[..., :3])
    inv_w = 1.0 / planes[..., 3][..., None]
    m0, m1, m2 = m[..., 0, None], m[..., 1, None], m[..., 2, None]
    A, B = vg.A, vg.B
    xv, yv = x[..., None], y[..., None]

    def warp(di, dj):
        qx, qy = xv + di, yv + dj
        mq = (m0 * qx + m1 * qy + m2) * inv_w
        px = A[:, 0, 0] * qx + A[:, 0, 1] * qy + A[:, 0, 2] - B[:, 0] * mq
        py = A[:, 1, 0] * qx + A[:, 1, 1] * qy + A[:, 1, 2] - B[:, 1] * mq
        pz = A[:, 2, 0] * qx + A[:, 2, 1] * qy + A[:, 2, 2] - B[:, 2] * mq
        return px / pz, py / pz

    sw, sh = vg.src_width, vg.src_height
    cx, cy = warp(0.0, 0.0)
    in_bounds = (cx >= 0.0) & (cx < sw) & (cy >= 0.0) & (cy < sh)
    inv_2sc2 = 1.0 / (2.0 * params.sigma_color ** 2)
    s_r = s_rr = s_s = s_ss = s_rs = s_w = 0.0
    for di, dj, w_sp in ncc_ops.tap_weights_spatial(params):
        r = ncc_ops._shift_edge(ref_img, dj, di)
        w = (w_sp * torch.exp(-torch.abs(r - ref_img) * inv_2sc2))[..., None]
        r = r[..., None]
        s = ncc_ops.sample_views(src_imgs, *warp(float(di), float(dj)),
                                 sw, sh)
        s_r, s_rr = s_r + w * r, s_rr + w * r * r
        s_s, s_ss = s_s + w * s, s_ss + w * s * s
        s_rs, s_w = s_rs + w * r * s, s_w + w
    inv = 1.0 / s_w
    mr, ms = s_r * inv, s_s * inv
    vr, vs = s_rr * inv - mr * mr, s_ss * inv - ms * ms
    cov = s_rs * inv - mr * ms
    ncc = torch.clamp(1.0 - cov / torch.sqrt(torch.clamp(vr * vs, min=1e-30)),
                      0.0, params.cost_max)
    bad = (vr < params.min_var) | (vs < params.min_var)
    cost = torch.where(bad, params.cost_max, ncc)
    return torch.where(in_bounds, cost, params.cost_max)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_zncc_conditioning: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from acmmp_tpu_torch.config import PatchMatchParams
    from acmmp_tpu_torch.core import geometry as geo
    from acmmp_tpu_torch.engine.inputs import build_solver_inputs
    from acmmp_tpu_torch.ops import keys, sampling
    from acmmp_tpu_torch.ops import ncc as ncc_ops
    from acmmp_tpu_torch.utils.synth import textured_plane_scene

    dev = torch.device("cuda")
    params = PatchMatchParams()
    plain = PatchMatchParams(ncc_backend="plain")
    print(torch.cuda.get_device_name(0), flush=True)
    for width, height, n_src in ((320, 240, 4), (1600, 1184, 8)):
        images, cams, plane_z = textured_plane_scene(
            n_views=n_src + 1, width=width, height=height,
            f=600.0 * width / 320.0, plane_z=5.0)
        inp = build_solver_inputs(images[0], images[1:], cams[0], cams[1:],
                                  params, device=dev)
        H, W = inp.ref_img.shape
        x, y = geo.pixel_grid(H, W, device=dev)
        cam = inp.ref_cam
        n_cam = geo.normal_world_to_cam(
            cam, torch.tensor([0.0, 0.0, -1.0], device=dev).expand(H, W, 3))
        fields = {
            "coherent": geo.plane_from_depth_normal(
                cam, x, y, torch.full((H, W), plane_z, device=dev), n_cam),
            "random": sampling.random_plane(
                keys.key(3), cam, x, y, inp.depth_min, inp.depth_max,
                tile_window=0.125, min_cos=0.25),
        }
        vg = ncc_ops.make_view_geometry(cam, inp.src_cams)
        vg64 = ncc_ops.ViewGeometry(*(t.double() for t in vg))
        for name, planes in fields.items():
            planes = planes[None].contiguous()
            f64 = ncc_ops.multiview_zncc(
                inp.ref_img.double(), inp.src_imgs.double(), vg64,
                planes.double(), plain)[0]
            evals = {
                "kernel (centred f32)": ncc_ops.multiview_zncc(
                    inp.ref_img, inp.src_imgs, vg, planes, params)[0],
                "plain (centred f32)": ncc_ops.multiview_zncc(
                    inp.ref_img, inp.src_imgs, vg, planes, plain)[0],
                "uncentred f32 (JAX oracle's form)": uncentred_zncc(
                    inp.ref_img, inp.src_imgs, vg, planes[0], plain,
                    ncc_ops, geo),
            }
            for label, cost in evals.items():
                d = (cost.double() - f64).abs()
                miss = (d > 2e-3 + 1e-3 * f64.abs()).double().mean().item()
                print(f"{width}x{height} {name:8s} {label:34s} misses f64 "
                      f"beyond the ZNCC bar on {miss:.3e} of costs; "
                      f"median |d| {d.median().item():.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
