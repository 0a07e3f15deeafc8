"""Consistency-based depth/normal fusion into a colored point cloud — the
port of ``acmmp_tpu/engine/fusion.py``.

Re-designs RunFusion (src/acmmp_definitions.cpp:828-1043) and the
prior-aware dual-hypothesis variant RunPriorAwareFusion (:573-826).

The reference is a sequential per-pixel host loop whose only cross-pixel
coupling is the greedy consumption masks (accepted points mark their
supporting source pixels as used). As in the JAX package, the
per-reference-view work (project every pixel into every source view, read
the source maps, threshold, score) is tensor code on the device, and the
greedy masks live on the host and are updated *between* reference views:
within one reference view, pixels are scored against the masks as they
stood when the view started (DEVIATIONS.md). The source-map read is
ops/sample.py, the hand-written CUDA kernel on CUDA tensors: one launch
per reference view with sources in plain fusion (4 channels), two in the
prior-aware fusion (one per reference candidate, 8 channels).

Three rules the JAX program gets from XLA and the port states itself:
  * the camera products, the reprojection error, the angle and the
    dynamic score round as XLA:CPU rounds the compiled JAX program on a
    host with FMA (core/fused_math.py), so both packages take the same
    accept decisions from the same checkpoints;
  * a projection that is NaN or infinite is out of bounds: its lanes are
    invalid and no integer is formed from them (torch and CUDA convert
    NaN to an integer differently);
  * the consumed-pixel scatter has duplicate indices that carry True and
    False; it is a ``scatter_reduce`` amax on uint8, whose result does
    not depend on the order of the writes.

On a device mesh (parallel/sharding.py) the views fuse in groups of mesh
size: member k computes the consistency parts of the group's k-th view
on its device (project, sample, threshold, score), every member's parts
issued before any is read, the parts are gathered to every rank, and
the greedy consumption chain is replayed on the host in the sequential
order, so the cloud is the sequential one, bit for bit
(``_fuse_group_sharded``). Across processes every rank replays the same
chain; rank 0 alone writes the PLY and the debug images
(parallel/multihost.py).
"""

from __future__ import annotations

import dataclasses
import functools
import operator
import os
from collections import OrderedDict
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from acmmp_tpu_torch import runtime
from acmmp_tpu_torch.config import FusionParams
from acmmp_tpu_torch.core import fused_math as fm
from acmmp_tpu_torch.core import geometry as geo
from acmmp_tpu_torch.io import read_dmb, write_ply
from acmmp_tpu_torch.io.dense_folder import (
    NumpyCamera, Problem, cam_path, image_path, load_image_color,
    read_cam_txt, resize_image, result_dir,
)
from acmmp_tpu_torch.ops import sample as sample_ops
from acmmp_tpu_torch.parallel import multihost as mh
from acmmp_tpu_torch.parallel.sharding import gather_members


# ---------------------------------------------------------------------------
# per-reference-view tensor work
# ---------------------------------------------------------------------------

def _per_view(cams: geo.Camera) -> geo.Camera:
    """A stacked [V] camera with two unit axes after the view axis, so it
    broadcasts against [V, H, W] pixel fields."""
    return geo.Camera(*(getattr(cams, f.name)[:, None, None]
                        for f in dataclasses.fields(geo.Camera)))


# The camera math of fusion rounds as the JAX package's compiled fusion
# program does on the CPU (core/fused_math.py): each 3x3 product is a chain
# of fused multiply-adds, the translations and divisions are rounded
# apart. The solver's camera math (core/geometry.py) is not touched.

def _world_point(cam: geo.Camera, x, y, depth) -> torch.Tensor:
    """geometry.world_point: R^T (backproject(x, y, depth) - t)."""
    X = geo.backproject(cam, x, y, depth) - cam.t
    return fm.matvec(cam.R.transpose(-1, -2), X)


def _project(cam: geo.Camera, X: torch.Tensor):
    """geometry.project: (pixel xy, depth) of world points."""
    h = fm.matvec(cam.K, fm.matvec(cam.R, X) + cam.t)
    depth = h[..., 2]
    return h[..., :2] / depth[..., None], depth


def _angle(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Angle between unit vectors, NaN-safe (GetAngle,
    ACMMP.cpp:253-262)."""
    ang = fm.acos(torch.clamp(fm.dot3(v1, v2), -1.0, 1.0))
    return torch.where(torch.isnan(ang), 0.0, ang)


def _project_index(src_cams: geo.Camera, Xw: torch.Tensor, Hs: int,
                   Ws: int):
    """Nearest source pixel of each reference pixel in each view: (rr, cc)
    int32 [V, H, W] clipped to the maps, and whether the pixel lies
    inside the view's true extent. The rounding and bounds are taken in
    float, so a NaN or infinite projection is out of bounds and forms no
    integer; for finite ones this equals the JAX package's
    round-cast-compare-clip."""
    uv, _ = _project(src_cams, Xw)
    c = torch.floor(uv[..., 0] + 0.5)
    r = torch.floor(uv[..., 1] + 0.5)
    inb = (torch.isfinite(c) & torch.isfinite(r)
           & (c >= 0) & (c < src_cams.width)
           & (r >= 0) & (r < src_cams.height))
    cc = torch.clamp(torch.where(inb, c, 0.0), 0, Ws - 1).to(torch.int32)
    rr = torch.clamp(torch.where(inb, r, 0.0), 0, Hs - 1).to(torch.int32)
    return rr, cc, inb


def _per_view_consistency(ref_cam, src_cams, recons, src_masks, Xw,
                          ref_depth, ref_normal, x, y, rv,
                          fp: FusionParams):
    """Project ref pixels into each source view and score consistency.

    `recons` is a sequence of (src_depths [V,Hs,Ws], src_normals
    [V,Hs,Ws,3]) reconstructions scored against the SAME projection (the
    dual-candidate fusion scores each candidate against both recons);
    `rv` is the ref-side candidate validity. The source-map reads are one
    gather (ops/sample.py); masks fold into the depth channel
    (`~smask & sdepth>0` == `depth_eff>0`), and lanes outside `inb & rv`
    read zeros — every consumer gates those lanes out.

    Returns ([(consistent [V,H,W], dyn [V,H,W])] per recon, src_r,
    src_c)."""
    Hs, Ws = recons[0][0].shape[1:]
    cams_v = _per_view(src_cams)
    rr, cc, inb = _project_index(cams_v, Xw, Hs, Ws)
    maps = torch.cat([
        torch.cat([torch.where(src_masks, 0.0, sd)[:, None],
                   sn.permute(0, 3, 1, 2)], dim=1)
        for sd, sn in recons], dim=1).contiguous()   # [V, 4*n_recons, Hs, Ws]
    smp = sample_ops.gather2d_sample(maps, rr, cc, inb & rv[None],
                                     backend=fp.sample_backend)

    outs = []
    for k in range(len(recons)):
        sdepth = smp[:, 4 * k]
        snormal = smp[:, 4 * k + 1:4 * k + 4].permute(0, 2, 3, 1)
        Xs = _world_point(cams_v, cc.float(), rr.float(), sdepth)
        buv, proj_depth = _project(ref_cam, Xs)
        dx, dy = x - buv[..., 0], y - buv[..., 1]
        err = fm.sqrt(fm.fma(dx, dx, dy * dy))
        rdd = (torch.abs(proj_depth - ref_depth)
               / torch.clamp(ref_depth, min=1e-12))
        ang = _angle(ref_normal, snormal)
        ok = (inb & (sdepth > 0.0)
              & (err < fp.max_reproj_error)
              & (rdd < fp.max_relative_depth_diff)
              & (ang < fp.max_normal_angle))
        dyn = fm.exp(-fm.fma(ang, fp.angle_weight,
                             fm.fma(rdd, fp.depth_diff_weight, err)))
        outs.append((ok, torch.where(ok, dyn, 0.0)))
    return outs, rr, cc


def _sum_views(t):
    """t[0] + t[1] + ... in that order: the views' consistency sum as a
    left fold of elementwise f32 adds, so that the device's sum and the
    host chain of the mesh path (numpy, _fuse_group_sharded) round
    alike; a library reduction may reassociate."""
    return functools.reduce(operator.add, t)


def _consume(accept, ok, rr, cc, src_masks):
    """Source pixels supporting an accepted point: [V, Hs, Ws] bool. The
    scatter is an amax on uint8, so duplicate indices carrying True and
    False give the same result in any order."""
    V, Hs, Ws = src_masks.shape
    vals = (accept[None] & ok).to(torch.uint8).reshape(V, -1)
    idx = (rr.long() * Ws + cc.long()).reshape(V, -1)
    flat = torch.zeros((V, Hs * Ws), dtype=torch.uint8, device=ok.device)
    flat.scatter_reduce_(1, idx, vals, "amax")
    return flat.reshape(V, Hs, Ws).bool()


def _fuse_view_plain_parts(ref_depth, ref_normal, ref_mask, ref_cam,
                           src_cams, src_depths, src_normals, src_masks,
                           view_mask, fp: FusionParams):
    """The per-view work of plain fusion WITHOUT the greedy acceptance:
    per-view consistency flags/scores and source coordinates."""
    H, W = ref_depth.shape
    x, y = geo.pixel_grid(H, W, device=ref_depth.device)
    valid = ((~ref_mask) & (ref_depth > 0.0)
             & (ref_depth < ref_cam.depth_max))
    Xw = _world_point(ref_cam, x, y, ref_depth)
    [(ok, dyn)], rr, cc = _per_view_consistency(
        ref_cam, src_cams, [(src_depths, src_normals)], src_masks, Xw,
        ref_depth, ref_normal, x, y, valid, fp,
    )
    ok = ok & view_mask[:, None, None]
    return valid, Xw, ok, dyn, rr, cc


def _fuse_view_plain(ref_depth, ref_normal, ref_mask, ref_cam, src_cams,
                     src_depths, src_normals, src_masks, view_mask,
                     fp: FusionParams):
    valid, Xw, ok, dyn, rr, cc = _fuse_view_plain_parts(
        ref_depth, ref_normal, ref_mask, ref_cam, src_cams, src_depths,
        src_normals, src_masks, view_mask, fp)
    n_cons = ok.sum(0)
    d_cons = _sum_views(torch.where(ok, dyn, 0.0))
    accept = valid & (n_cons >= fp.num_consistent_thresh) & (
        d_cons > fp.consistency_scalar * n_cons)
    return accept, Xw, _consume(accept, ok, rr, cc, src_masks)


def _fuse_view_dual_parts(ref_depth0, ref_normal0, ref_depth1, ref_normal1,
                          ref_mask, ref_cam, src_cams,
                          src_depths0, src_normals0, src_depths1,
                          src_normals1, src_masks, view_mask,
                          fp: FusionParams):
    """Per-candidate consistency parts of dual fusion."""
    H, W = ref_depth0.shape
    x, y = geo.pixel_grid(H, W, device=ref_depth0.device)
    v0 = (~ref_mask) & (ref_depth0 > 0.0)
    v1 = (~ref_mask) & (ref_depth1 > 0.0)

    def score(ref_depth, ref_normal, rv):
        Xw = _world_point(ref_cam, x, y, ref_depth)
        [(ok0, dyn0), (ok1, dyn1)], rr, cc = _per_view_consistency(
            ref_cam, src_cams,
            [(src_depths0, src_normals0), (src_depths1, src_normals1)],
            src_masks, Xw, ref_depth, ref_normal, x, y, rv, fp)
        ok = (ok0 | ok1) & view_mask[:, None, None]
        dyn = torch.where(ok0 & ok1, torch.maximum(dyn0, dyn1),
                          torch.where(ok0, dyn0, dyn1))
        dyn = torch.where(ok, dyn, 0.0)
        return Xw, ok, dyn, rr, cc

    return v0, v1, score(ref_depth0, ref_normal0, v0), \
        score(ref_depth1, ref_normal1, v1)


def _fuse_view_dual(ref_depth0, ref_normal0, ref_depth1, ref_normal1,
                    ref_mask, ref_cam, src_cams,
                    src_depths0, src_normals0, src_depths1, src_normals1,
                    src_masks, view_mask, single_match_penalty,
                    fp: FusionParams):
    """Dual-hypothesis prior-aware fusion: candidate 0 = base recon,
    candidate 1 = second recon; each candidate is scored against BOTH
    source recons per view taking the better (get_consistency_metrics,
    acmmp_definitions.cpp:454-518)."""
    v0, v1, p0, p1 = _fuse_view_dual_parts(
        ref_depth0, ref_normal0, ref_depth1, ref_normal1, ref_mask,
        ref_cam, src_cams, src_depths0, src_normals0, src_depths1,
        src_normals1, src_masks, view_mask, fp)
    Xw0, ok_v0, dyn_v0, rr, cc = p0
    Xw1, ok_v1, dyn_v1, rr1, cc1 = p1
    thr, cs = fp.num_consistent_thresh, fp.consistency_scalar
    n0, n1 = ok_v0.sum(0), ok_v1.sum(0)
    d0, d1 = _sum_views(dyn_v0), _sum_views(dyn_v1)
    pass0 = (n0 >= thr) & (d0 > cs * n0) & v0
    pass1 = (n1 >= thr) & (d1 > cs * n1) & v1

    both = pass0 & pass1
    use1 = torch.where(both, n1 >= n0, pass1)
    harsh = thr + single_match_penalty
    single_ok = torch.where(use1, n1 >= harsh, n0 >= harsh)
    accept = (both | ((pass0 | pass1) & single_ok)) & (v0 | v1)

    Xw = torch.where(use1[..., None], Xw1, Xw0)
    normal = torch.where(use1[..., None], ref_normal1, ref_normal0)
    ok = torch.where(use1[None], ok_v1, ok_v0)
    crr = torch.where(use1[None], rr1, rr)
    ccc = torch.where(use1[None], cc1, cc)
    return accept, Xw, normal, _consume(accept, ok, crr, ccc, src_masks)


# ---------------------------------------------------------------------------
# host orchestration over reference views
# ---------------------------------------------------------------------------

class FusionView:
    """Loaded per-view fusion inputs (image rescaled to depth resolution,
    camera intrinsics rescaled accordingly — RescaleImageAndCamera,
    src/ACMMP.cpp:181-202)."""

    def __init__(self, image_rgb, cam: NumpyCamera, depth, normal,
                 mask=None, depth1=None, normal1=None):
        h, w = depth.shape
        K = cam.K
        if image_rgb.shape[:2] != (h, w):
            sx, sy = w / image_rgb.shape[1], h / image_rgb.shape[0]
            image_rgb = resize_image(image_rgb, w, h)
            K = cam.K.copy()
            K[0, :] *= sx
            K[1, :] *= sy
        self.image = image_rgb
        self.cam = NumpyCamera(K=K, R=cam.R, t=cam.t,
                               depth_min=cam.depth_min,
                               depth_max=cam.depth_max, width=w, height=h)
        self.depth = np.asarray(depth, np.float32)
        self.normal = np.asarray(normal, np.float32)
        self.depth1 = (None if depth1 is None
                       else np.asarray(depth1, np.float32))
        self.normal1 = (None if normal1 is None
                        else np.asarray(normal1, np.float32))
        self.mask = (np.zeros((h, w), bool) if mask is None
                     else np.asarray(mask, bool))


def _assemble_problem(prob, views, prior_aware, device, v_max=None,
                      sh=None, sw=None):
    """Per-reference-view fusion inputs on `device`, the sources padded to
    (v_max views, sh x sw): v_max=None pads to this problem's own sources
    (the sequential path); the mesh path passes the scene-wide shape, the
    extra view slots repeating the first source under a false view_mask.
    Masks are read HERE — the greedy consumption a problem sees is the
    mask state at assembly time."""
    i = prob.ref_image_id
    rv = views[i]
    src_ids = [s for s in prob.src_image_ids if s in views]
    if not src_ids:
        return None
    # fetch each view object ONCE (the stack passes below would otherwise
    # cyclically thrash a LazyFusionViews LRU smaller than the problem's
    # view set); local strong refs bound peak memory at exactly this
    # problem's working set
    held = {s: views[s] for s in src_ids}
    if v_max is None:
        v_max = len(src_ids)
        sh = max(v.depth.shape[0] for v in held.values())
        sw = max(v.depth.shape[1] for v in held.values())
    pad_ids = src_ids + [src_ids[0]] * (v_max - len(src_ids))

    def stack(get, fill=0.0):
        out = []
        for s in pad_ids:
            a = get(held[s])
            pad = [(0, sh - a.shape[0]), (0, sw - a.shape[1])]
            if a.ndim == 3:
                pad.append((0, 0))
            out.append(np.pad(a, pad, constant_values=fill))
        return np.stack(out)

    arrays = dict(
        ref_mask=np.asarray(rv.mask),
        src_masks=stack(lambda v: v.mask, fill=True),
        view_mask=np.arange(v_max) < len(src_ids),
    )
    if prior_aware:
        arrays.update(
            ref_depth0=rv.depth, ref_normal0=rv.normal,
            ref_depth1=rv.depth1, ref_normal1=rv.normal1,
            src_depths0=stack(lambda v: v.depth),
            src_normals0=stack(lambda v: v.normal),
            src_depths1=stack(lambda v: v.depth1),
            src_normals1=stack(lambda v: v.normal1),
        )
    else:
        arrays.update(
            ref_depth=rv.depth, ref_normal=rv.normal,
            src_depths=stack(lambda v: v.depth),
            src_normals=stack(lambda v: v.normal),
        )
    tensors = {k: torch.as_tensor(np.ascontiguousarray(a), device=device)
               for k, a in arrays.items()}
    tensors.update(ref_cam=rv.cam.to_torch(device),
                   src_cams=geo.stack_cameras(
                       [held[s].cam.to_torch(device) for s in pad_ids]))
    return i, rv, src_ids, tensors


def _collect_accepted(i, rv, src_ids, views, accept, Xw, normal, consumed,
                      sinks, progress, debug_dir):
    """Apply one fused view's results: collect points, consume source
    pixels, report acceptance, optionally write the approved-pixel debug
    image (the reference writes approved_pixels_cam_N.png,
    acmmp_definitions.cpp:1035-1038)."""
    pts_out, nrm_out, col_out = sinks
    accept, Xw, consumed = _np(accept), _np(Xw), _np(consumed)
    normal = rv.normal if normal is None else _np(normal)
    pts_out.append(Xw[accept])
    nrm_out.append(normal[accept])
    col_out.append(rv.image[accept])
    mask_of = getattr(views, "mask_of", None)
    for j, s in enumerate(src_ids):
        # LazyFusionViews holds the pinned masks directly — don't reload a
        # whole evicted view's arrays just to OR its consumption mask
        m = mask_of(s) if mask_of is not None else views[s].mask
        m |= consumed[j][:m.shape[0], :m.shape[1]]
    if progress is not None:
        progress(i, int(np.sum(accept)))
    if debug_dir is not None:
        from PIL import Image as PILImage

        os.makedirs(debug_dir, exist_ok=True)
        mh.on_primary(PILImage.fromarray((accept * 255).astype(np.uint8)).save,
                      os.path.join(debug_dir, f"approved_pixels_cam_{i}.png"))


def _np(a):
    return a if isinstance(a, np.ndarray) else a.cpu().numpy()


def fuse_views(views: Dict[int, FusionView], problems: Sequence[Problem],
               fp: FusionParams, prior_aware: bool = False,
               single_match_penalty: int = 0, progress=None,
               debug_dir: Optional[str] = None, device=None, mesh=None):
    """Fuse all reference views into (points, normals, colors) numpy
    arrays, the per-view work on `device` (CUDA unless told otherwise),
    or on the members of `mesh`.

    `views` maps image id -> FusionView; masks mutate greedily between
    reference views exactly like the reference's outer loop
    (acmmp_definitions.cpp:920-1031). With a mesh, groups of mesh-size
    views are scored in parallel, one per member, at the scene-wide
    padded source shape, and the greedy consumption is replayed on the
    host from the returned parts (_fuse_group_sharded): the cloud equals
    the sequential one."""
    sinks = ([], [], [])
    probs = [p for p in problems
             if [s for s in p.src_image_ids if s in views]]
    pad = dict(v_max=None, sh=None, sw=None)
    if mesh is None:
        devices = [runtime.resolve_device(device)]
    else:
        devices = list(mesh)
        # the scene-wide padded shape: every member's stacks alike, as
        # the JAX package's one program over the group needs them
        all_ids = {p.ref_image_id for p in probs} | {
            s for p in probs for s in p.src_image_ids if s in views}
        pad = dict(
            v_max=max((len([s for s in p.src_image_ids if s in views])
                       for p in probs), default=0),
            sh=max((views[i].depth.shape[0] for i in all_ids), default=1),
            sw=max((views[i].depth.shape[1] for i in all_ids), default=1))

    for g0 in range(0, len(probs), len(devices)):
        group = probs[g0:g0 + len(devices)]
        if mesh is None:
            i, rv, src_ids, kw = _assemble_problem(group[0], views,
                                                   prior_aware, devices[0])
            if prior_aware:
                res = _fuse_view_dual(
                    single_match_penalty=single_match_penalty, fp=fp, **kw)
            else:
                accept, Xw, consumed = _fuse_view_plain(fp=fp, **kw)
                res = (accept, Xw, None, consumed)
            results = [((i, rv, src_ids), res)]
        else:
            results = _fuse_group_sharded(mesh, group, views, prior_aware,
                                          single_match_penalty, fp, pad)
        for (i, rv, src_ids), (accept, Xw, normal, consumed) in results:
            _collect_accepted(i, rv, src_ids, views, accept, Xw, normal,
                              consumed, sinks, progress, debug_dir)
    pts_out, nrm_out, col_out = sinks
    if not pts_out:
        z = np.zeros((0, 3), np.float32)
        return z, z.copy(), np.zeros((0, 3), np.uint8)
    return (np.concatenate(pts_out), np.concatenate(nrm_out),
            np.concatenate(col_out).astype(np.uint8))


def _fuse_group_sharded(mesh, group, views, prior_aware,
                        single_match_penalty, fp: FusionParams, pad):
    """Fuse one group of reference views (problem k on member k), each of
    this process's assembled on its member's device at the scene-wide
    padded shape `pad`: every member's consistency parts (project,
    sample, threshold, score) are issued before any is read, then
    gathered to every rank (parallel.sharding.gather_members), and the
    reference's sequential greedy consumption chain is replayed on the
    host from the parts, so every member sees the mask state of the
    sequential loop and the results are the sequential fusion's. Returns
    per problem ((id, view, source ids), (accept, Xw, normal or None,
    consumed)), numpy."""
    mine = {}
    for m in mesh.local():
        if m < len(group):
            *_h, kw = _assemble_problem(group[m], views, prior_aware,
                                        mesh[m], **pad)
            if prior_aware:
                v0, v1, p0, p1 = _fuse_view_dual_parts(fp=fp, **kw)
                mine[m] = (v0, v1, *p0, *p1)
            else:
                mine[m] = _fuse_view_plain_parts(fp=fp, **kw)
    res = []
    for parts in gather_members(mesh, mine)[:len(group)]:
        parts = tuple(_np(q) for q in parts)
        res.append((*parts[:2], parts[2:7], parts[7:]) if prior_aware
                   else parts)
    heads = [(p.ref_image_id, views[p.ref_image_id],
              [s for s in p.src_image_ids if s in views]) for p in group]

    # delta[s]: source pixels of view s consumed by EARLIER members of
    # this group (the consumption before the group is already in the
    # masks the parts were scored against)
    delta: Dict[int, np.ndarray] = {}
    thr = fp.num_consistent_thresh
    cs = np.float32(fp.consistency_scalar)

    def masked_ok(ok, rr, cc, src_ids):
        ok = ok.copy()
        for j, s in enumerate(src_ids):
            dm = delta.get(s)
            if dm is not None:
                ok[j] &= ~dm[rr[j], cc[j]]
        return ok

    def ref_delta(i, valid):
        dm = delta.get(i)
        if dm is None:
            return valid
        h, w = valid.shape
        crop = np.zeros((h, w), bool)
        hh, ww = min(h, dm.shape[0]), min(w, dm.shape[1])
        crop[:hh, :ww] = dm[:hh, :ww]
        return valid & ~crop

    def sums(ok, dyn):
        # (count, f32 sum) of the consistent views, and the threshold
        # cs * count in f32 as the device forms it
        n = ok.sum(0)
        return (n, _sum_views(np.where(ok, dyn, np.float32(0.0))),
                cs * n.astype(np.float32))

    def consume(accept, ok, rr, cc, src_ids, shape):
        consumed = np.zeros((len(ok),) + shape, bool)
        for j, s in enumerate(src_ids):
            sel = accept & ok[j]
            consumed[j, rr[j][sel], cc[j][sel]] = True
            dm = delta.setdefault(s, np.zeros(shape, bool))
            dm |= consumed[j]
        return consumed

    out = []
    shape = (pad["sh"], pad["sw"])
    for (i, rv, src_ids), r in zip(heads, res):
        if prior_aware:
            v0, v1 = ref_delta(i, r[0]), ref_delta(i, r[1])
            Xw0, ok0, dyn0, rr0, cc0 = r[2]
            Xw1, ok1, dyn1, rr1, cc1 = r[3]
            ok0 = masked_ok(ok0, rr0, cc0, src_ids)
            ok1 = masked_ok(ok1, rr1, cc1, src_ids)
            n0, d0, t0 = sums(ok0, dyn0)
            n1, d1, t1 = sums(ok1, dyn1)
            pass0 = (n0 >= thr) & (d0 > t0) & v0
            pass1 = (n1 >= thr) & (d1 > t1) & v1
            both = pass0 & pass1
            use1 = np.where(both, n1 >= n0, pass1)
            harsh = thr + single_match_penalty
            single_ok = np.where(use1, n1 >= harsh, n0 >= harsh)
            accept = (both | ((pass0 | pass1) & single_ok)) & (v0 | v1)
            Xw = np.where(use1[..., None], Xw1, Xw0)
            normal = np.where(use1[..., None], rv.normal1, rv.normal)
            ok = np.where(use1[None], ok1, ok0)
            rr = np.where(use1[None], rr1, rr0)
            cc = np.where(use1[None], cc1, cc0)
        else:
            valid, Xw, ok, dyn, rr, cc = r
            ok = masked_ok(ok, rr, cc, src_ids)
            valid = ref_delta(i, valid)
            nc, dc, tc = sums(ok, dyn)
            accept = valid & (nc >= thr) & (dc > tc)
            normal = None
        out.append(((i, rv, src_ids),
                    (accept, Xw, normal,
                     consume(accept, ok, rr, cc, src_ids, shape))))
    return out


def _write_ply_primary(ply_path, pts, nrm, col) -> str:
    """Every process holds the same cloud; rank 0 writes the PLY, and every
    process waits for it."""
    mh.on_primary(write_ply, ply_path, pts, nrm, col)
    mh.barrier("fusion_ply")
    return ply_path


class LazyFusionViews(Mapping):
    """Memory-bounded fusion view set: loads each view's heavy arrays
    (image/depth/normal) on demand and keeps at most `max_cached` views
    resident (LRU), while the greedy-consumption masks are pinned for the
    whole fusion — evict/reload preserves the exact sequential mask state
    (checkpoint arrays on disk are immutable during fusion; only masks
    mutate). The reference loads every view up front
    (acmmp_definitions.cpp:852-914): ~150 MB/view at DTU full resolution,
    ~9 GB host for a 64-view scan — this keeps fusion O(cache) instead."""

    def __init__(self, ids, load_one, max_cached: int):
        self._ids = list(ids)
        self._idset = set(ids)
        self._load_one = load_one
        # a problem touches itself + its sources each step; anything
        # smaller than 2 would thrash within a single assembly
        self._cap = max(int(max_cached), 2)
        self._masks: Dict[int, np.ndarray] = {}
        self._cache = OrderedDict()

    def __getitem__(self, i):
        if i not in self._idset:
            raise KeyError(i)
        fv = self._cache.get(i)
        if fv is None:
            fv = self._load_one(i)
            # pin the mask: first load donates its (mask_dir-initialized)
            # mask; reloads adopt the accumulated one
            fv.mask = self._masks.setdefault(i, fv.mask)
            self._cache[i] = fv
            while len(self._cache) > self._cap:
                self._cache.popitem(last=False)
        else:
            self._cache.move_to_end(i)
        return fv

    def mask_of(self, i) -> np.ndarray:
        """The pinned consumption mask for view `i`, WITHOUT keeping the
        view's heavy arrays resident (first access loads once to pick up
        the mask_dir initialization)."""
        m = self._masks.get(i)
        if m is None:
            m = self[i].mask
        return m

    def __iter__(self):
        return iter(self._ids)

    def __len__(self):
        return len(self._ids)

    def __contains__(self, i):
        return i in self._idset


def load_fusion_views(dense_folder: str, out_folder: str,
                      problems: Sequence[Problem], geom_consistency: bool,
                      image_dir: str = "images",
                      mask_dir: Optional[str] = None,
                      second_folder: Optional[str] = None,
                      max_cached: int = 0) -> Mapping:
    """Load depth/normal checkpoints + images for fusion (RunFusion's
    loader, acmmp_definitions.cpp:852-914). If `second_folder` is given,
    also load the dual-hypothesis recon from it (prior-aware fusion). With
    `max_cached > 0`, views are loaded lazily with an LRU cap instead of
    all up front (LazyFusionViews)."""
    from PIL import Image as PILImage

    suffix = "depths_geom.dmb" if geom_consistency else "depths.dmb"

    def load_one(i: int) -> FusionView:
        rdir = result_dir(out_folder, i)
        depth = read_dmb(os.path.join(rdir, suffix))
        normal = read_dmb(os.path.join(rdir, "normals.dmb"))
        img = load_image_color(image_path(dense_folder, i, image_dir))
        cam = read_cam_txt(cam_path(dense_folder, i))
        mask = None
        if mask_dir:
            mpath = os.path.join(dense_folder, mask_dir, f"{i:08d}.png")
            if os.path.exists(mpath):
                m = np.asarray(PILImage.open(mpath).convert("L"))
                m = resize_image(m, depth.shape[1], depth.shape[0])
                mask = m < 128
        d1 = n1 = None
        if second_folder is not None:
            rdir1 = result_dir(second_folder, i)
            d1 = read_dmb(os.path.join(rdir1, suffix))
            n1 = read_dmb(os.path.join(rdir1, "normals.dmb"))
        return FusionView(img, cam, depth, normal, mask=mask,
                          depth1=d1, normal1=n1)

    ids = [p.ref_image_id for p in problems]
    if max_cached > 0:
        return LazyFusionViews(ids, load_one, max_cached)
    return {i: load_one(i) for i in ids}


def run_fusion(dense_folder: str, out_folder: str,
               problems: Sequence[Problem], geom_consistency: bool,
               fp: FusionParams, image_dir: str = "images",
               mask_dir: Optional[str] = None,
               ply_name: str = "ACMMP_model.ply", progress=None,
               debug_dir: Optional[str] = None, view_cache: int = 0,
               device=None, mesh=None) -> str:
    views = load_fusion_views(dense_folder, out_folder, problems,
                              geom_consistency, image_dir, mask_dir,
                              max_cached=view_cache)
    pts, nrm, col = fuse_views(views, problems, fp, progress=progress,
                               debug_dir=debug_dir, device=device,
                               mesh=mesh)
    return _write_ply_primary(os.path.join(out_folder, ply_name), pts, nrm,
                              col)


def run_prior_aware_fusion(dense_folder: str, out_folder: str,
                           fusion_folder: str, problems: Sequence[Problem],
                           geom_consistency: bool, fp: FusionParams,
                           single_match_penalty: int = 0,
                           mask_dir: Optional[str] = None,
                           ply_name: str = "ACMMP_prior_model.ply",
                           progress=None, debug_dir: Optional[str] = None,
                           view_cache: int = 0, device=None,
                           mesh=None) -> str:
    """Dual-hypothesis fusion: candidate 0 from `fusion_folder`, candidate
    1 from `out_folder` (RunPriorAwareFusion,
    acmmp_definitions.cpp:573-826)."""
    views = load_fusion_views(dense_folder, fusion_folder, problems,
                              geom_consistency, mask_dir=mask_dir,
                              second_folder=out_folder,
                              max_cached=view_cache)
    pts, nrm, col = fuse_views(views, problems, fp, prior_aware=True,
                               single_match_penalty=single_match_penalty,
                               progress=progress, debug_dir=debug_dir,
                               device=device, mesh=mesh)
    return _write_ply_primary(os.path.join(out_folder, ply_name), pts, nrm,
                              col)
