"""Multi-scale reconstruction scheduler — the port of
``acmmp_tpu/pipeline/scheduler.py``.

The stage graph of the reference CLI (main_ACMMP.cpp:96-196):

  scale S (coarsest) .. 0 (finest):
    S:    photometric(+seeded) pass with planar-prior second solve,
          then 2 geometric-consistency passes (2nd with multi_geometry)
    <S:   JBU-upsample previous depths -> hierarchy pass (planar-prior
          second solve, hierarchy acceptance gate), then 2 geometric passes
  finally: fusion (plain or prior-aware) -> PLY

Stage-to-stage contract is the filesystem, byte-compatible with the
reference (<out>/2333_%08d/{depths,depths_geom,normals,costs}.dmb), so runs
are resumable at stage granularity and cross-checkable against the
reference binaries and the JAX package. Every solve and JBU runs on one
device (CUDA unless told otherwise), or on the members of a device mesh
(parallel/); images, priors and checkpoints stay on the host between
stages. Each pass solves its views in batches of ``view_batch``
(``process_batch``, pipeline/batched.py; one view each by default, at
least the mesh size on a mesh), in the JAX package's order: every view of
a batch is read before any is written, so with ``view_batch > 1`` a
multi_geometry pass reads its batch-mates' maps of the previous pass
where batches of one read those the pass already wrote.

On a mesh, as in the JAX package: a view above ``cfg.tile_pixels``
solves with its image rows sharded over every member
(parallel/tiles.py), views one after another; other views solve as a
batch sharded over the members (parallel/sharding.py); a geometric pass
reads each view's own depth map once into a bank that every member
receives (the all-gather), instead of reading every problem's source
maps from disk; and fusion scores groups of mesh-size views on the
members.

Across processes (parallel/multihost.py) every rank runs this schedule
over its own members of one global mesh and receives every member's
results, so every rank takes the same decisions; only rank 0 writes the
.dmb files, the pass markers, JBU's maps, the debug images and the PLY,
and a barrier follows each pass and JBU, as in the JAX package."""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from acmmp_tpu_torch import runtime
from acmmp_tpu_torch.config import PatchMatchParams, PipelineConfig
from acmmp_tpu_torch.engine.fusion import run_fusion, run_prior_aware_fusion
from acmmp_tpu_torch.engine.inputs import build_solver_inputs
from acmmp_tpu_torch.engine.patchmatch import Mode, SolverOutputs
from acmmp_tpu_torch.engine.priors import build_planar_prior
from acmmp_tpu_torch.io import read_dmb, write_dmb
from acmmp_tpu_torch.io.dense_folder import (
    Problem, cam_path, image_path, load_image_gray, read_cam_txt,
    read_pair_txt, rescale_to_max_size, result_dir,
)
from acmmp_tpu_torch.io.priors import load_seed_planes, priors_available
from acmmp_tpu_torch.ops import keys
from acmmp_tpu_torch.ops.jbu import jbu_depth, jbu_normal_cost
from acmmp_tpu_torch.ops import cuda_geom, cuda_ncc, cuda_sample
from acmmp_tpu_torch.parallel import multihost as mh
from acmmp_tpu_torch.parallel import tiles as tile_ops
from acmmp_tpu_torch.parallel.sharding import Mesh, gather_bank, member_rows
from acmmp_tpu_torch.pipeline.batched import BatchedSolver
from acmmp_tpu_torch.utils.log import get_logger, profiled, stage_metrics

log = get_logger("scheduler")


def generate_sample_list(dense_folder: str) -> List[Problem]:
    return read_pair_txt(os.path.join(dense_folder, "pair.txt"))


def compute_multiscale_settings(dense_folder: str, problems: List[Problem],
                                params: PatchMatchParams,
                                image_dir: str = "images") -> int:
    """Per-problem downscale counts (ComputeMultiScaleSettings,
    acmmp_definitions.cpp:207-243)."""
    from PIL import Image as PILImage

    max_num_downscale = -1
    for p in problems:
        with PILImage.open(image_path(dense_folder, p.ref_image_id,
                                      image_dir)) as im:
            w, h = im.size
        max_size = min(max(w, h), params.max_image_size)
        p.max_image_size = max_size
        k = 0
        while max_size > params.size_bound:
            max_size //= 2
            k += 1
        p.num_downscale = k
        max_num_downscale = max(max_num_downscale, k)
    return max_num_downscale


@dataclasses.dataclass
class _ViewData:
    image: np.ndarray
    cam: object


class ViewLoader:
    """Loads and caches grayscale images + cameras, rescaled per size.

    The raw cache stores uint8 (lossless — load_image_gray yields exact
    u8 values; 4x less host memory). The per-size f32 cache is a
    byte-budgeted LRU: the schedule is mostly coarse->fine so old sizes
    age out, but views that exhaust their downscale count early are
    re-requested at the SAME size every later scale and stay warm
    (clearing at scale boundaries would re-rescale them each scale)."""

    def __init__(self, dense_folder: str, image_dir: str = "images",
                 scaled_cache_bytes: int = 1 << 30):
        self.dense = dense_folder
        self.image_dir = image_dir
        self._raw: Dict[int, _ViewData] = {}
        self._scaled: "OrderedDict[tuple, _ViewData]" = OrderedDict()
        self._scaled_bytes = 0
        self._budget = scaled_cache_bytes

    def raw(self, image_id: int) -> _ViewData:
        if image_id not in self._raw:
            img = load_image_gray(image_path(self.dense, image_id,
                                             self.image_dir))
            cam = read_cam_txt(cam_path(self.dense, image_id))
            cam.width, cam.height = img.shape[1], img.shape[0]
            self._raw[image_id] = _ViewData(img.astype(np.uint8), cam)
        return self._raw[image_id]

    def at_size(self, image_id: int, max_size: int) -> _ViewData:
        key = (image_id, max_size)
        v = self._scaled.get(key)
        if v is None:
            raw = self.raw(image_id)
            img, cam = rescale_to_max_size(
                raw.image.astype(np.float32), raw.cam, max_size)
            v = _ViewData(img, cam)
            self._scaled[key] = v
            self._scaled_bytes += img.nbytes
            while self._scaled_bytes > self._budget and len(self._scaled) > 1:
                _, old = self._scaled.popitem(last=False)
                self._scaled_bytes -= old.image.nbytes
        else:
            self._scaled.move_to_end(key)
        return v


def _mode_desc(geom: bool, hierarchy: bool, seeded: bool,
               multi_geometry: bool) -> str:
    return ("geom2" if geom and multi_geometry else "geom" if geom
            else "hierarchy" if hierarchy
            else "seeded" if seeded else "photometric")


def _pass_marker_path(output_folder: str, rid: int, tag: int) -> str:
    return os.path.join(result_dir(output_folder, rid),
                        f".pass_{tag:03d}.json")


def _pass_done(output_folder: str, rid: int, tag: int, size: int) -> bool:
    """True when the (view, pass) solve already completed in a previous run
    with the same schedule (marker written by _mark_pass_done). The size
    check invalidates markers from a run with a different multi-scale
    schedule. The marker format is the JAX package's, so either package
    resumes the other's run."""
    p = _pass_marker_path(output_folder, rid, tag)
    if not os.path.exists(p):
        return False
    try:
        with open(p) as f:
            d = json.load(f)
    except (OSError, ValueError):
        return False
    return d.get("size") == size


def _mark_pass_done(output_folder: str, rid: int, tag: int, size: int,
                    desc: str) -> None:
    def write(path):
        with open(path, "w") as f:
            json.dump({"size": size, "pass": desc}, f)
    mh.on_primary(write, _pass_marker_path(output_folder, rid, tag))


def _on_host(out: SolverOutputs) -> SolverOutputs:
    return SolverOutputs(*(t.cpu().numpy() for t in out))


def _write_outputs(rdir: str, out: SolverOutputs, h: int, w: int,
                   geom: bool) -> None:
    os.makedirs(rdir, exist_ok=True)
    for name, a in (("depths_geom.dmb" if geom else "depths.dmb",
                     out.depth), ("normals.dmb", out.normal_world),
                    ("costs.dmb", out.cost)):
        mh.on_primary(write_dmb, os.path.join(rdir, name), a[:h, :w])


class _Prepared:
    """Host-side loaded inputs of one (view, scale, mode) solve."""

    def __init__(self, problem, ref, srcs, inputs, h, w, v_pad, src_depths,
                 tiled=False, pad_h=8):
        self.problem = problem
        self.ref = ref
        self.srcs = srcs
        self.inputs = inputs
        self.h = h
        self.w = w
        self.v_pad = v_pad
        self.src_depths = src_depths
        self.tiled = tiled        # solve with image rows sharded (tiles.py)
        self.pad_h = pad_h        # the row padding of its inputs


def _tile_plan(cfg, h: int, w: int, tile_devices: int):
    """(tiled, pad_h) for a view of true size (h, w): rows sharded when a
    mesh is present, the view exceeds cfg.tile_pixels, and every member
    gets at least the 24-row halo reach (parallel/tiles.py)."""
    if tile_devices < 2 or not cfg.tile_pixels or h * w <= cfg.tile_pixels:
        return False, cfg.pad_h
    m = 8 * tile_devices
    pad_h = m * max(1, (cfg.pad_h + m - 1) // m)
    hp = ((h + pad_h - 1) // pad_h) * pad_h
    if hp // tile_devices < tile_ops.HALO:
        return False, cfg.pad_h   # tiles would be thinner than the halo
    return True, pad_h


def _prepare_problem(dense_folder, output_folder, problems, idx, cfg,
                     loader, device, *, geom_consistency, hierarchy,
                     multi_geometry, seeded, skip_src_depth_files=False,
                     tile_devices=0):
    """Disk -> SolverInputs on `device` for one problem
    (InputInitialization, src/ACMMP.cpp:525-636). Returns None for skipped
    (sourceless) views.

    With `skip_src_depth_files` (the mesh path) the source depth maps are
    not read from disk: they come from the pass's bank
    (_src_depth_banks)."""
    params = cfg.patchmatch
    problem = problems[idx]
    rid = problem.ref_image_id
    if not problem.src_image_ids:
        log.warning("view %08d has no source views (pair.txt); skipping",
                    rid)
        return None
    rdir = result_dir(output_folder, rid)
    os.makedirs(rdir, exist_ok=True)
    id2prob = {p.ref_image_id: p for p in problems}

    ref = loader.at_size(rid, problem.cur_image_size)
    src_ids = problem.src_image_ids
    srcs = [
        loader.at_size(s, id2prob[s].cur_image_size if s in id2prob
                       else problem.cur_image_size)
        for s in src_ids
    ]
    h, w = ref.image.shape
    v_pad = max(len(p.src_image_ids) for p in problems)
    tiled, pad_h = _tile_plan(cfg, h, w, tile_devices)

    kw = {}
    suffix = "depths_geom.dmb" if multi_geometry else "depths.dmb"
    if geom_consistency:
        if not skip_src_depth_files:
            kw["src_depths"] = [
                read_dmb(os.path.join(result_dir(output_folder, s), suffix))
                for s in src_ids
            ]
        kw["init_depth"] = read_dmb(os.path.join(rdir, suffix))
        kw["init_normal_world"] = read_dmb(os.path.join(rdir, "normals.dmb"))
        kw["init_cost"] = read_dmb(os.path.join(rdir, "costs.dmb"))
    elif hierarchy:
        # coarse hypotheses from the previous scale; fine depth from JBU
        fine_depth = read_dmb(os.path.join(rdir, "depths.dmb"))
        coarse_normal = read_dmb(os.path.join(rdir, "normals.dmb"))
        coarse_cost = read_dmb(os.path.join(rdir, "costs.dmb"))
        gray = None
        if coarse_normal.shape[:2] != (h, w) or fine_depth.shape != (h, w):
            gray = torch.as_tensor(ref.image, device=device)
        if coarse_normal.shape[:2] != (h, w):
            normal_up, _cost_up = jbu_normal_cost(
                gray, torch.as_tensor(coarse_normal, device=device),
                torch.as_tensor(coarse_cost, device=device), params)
            kw["init_normal_world"] = normal_up.cpu().numpy()
        else:
            kw["init_normal_world"] = coarse_normal
        if fine_depth.shape != (h, w):
            # JBU was skipped (equal sizes upstream); resize naively
            fine_depth = jbu_depth(
                gray, torch.as_tensor(fine_depth, device=device),
                params).cpu().numpy()
        kw["init_depth"] = fine_depth
    elif seeded:
        seed_planes = load_seed_planes(dense_folder, rid, ref.cam, h, w)
        if seed_planes is None:
            raise FileNotFoundError(f"priors for view {rid} not found")
        kw["seed_planes"] = seed_planes

    inputs = build_solver_inputs(
        ref.image, [s.image for s in srcs], ref.cam, [s.cam for s in srcs],
        params, num_views_pad=v_pad, pad_h=pad_h, pad_w=cfg.pad_w,
        device=device, **kw,
    )
    return _Prepared(problem, ref, srcs, inputs, h, w, v_pad,
                     kw.get("src_depths"), tiled=tiled, pad_h=pad_h)


def _prior_second_solve_inputs(prep: _Prepared, out: SolverOutputs, cfg,
                               hierarchy, device, rdir=None):
    """Triangulated planar-prior inputs for the second solve, or None
    (GetSupportPoints..CudaPlanarPriorInitialization,
    acmmp_definitions.cpp:306-390). `out` holds the first solve's maps on
    the host."""
    params = cfg.patchmatch
    ref = prep.ref
    h, w = prep.h, prep.w
    dmin = float(ref.cam.depth_min * params.depth_min_relax)
    dmax = float(ref.cam.depth_max * params.depth_max_relax)
    # solver outputs are padded to [Hp, Wp]; triangulation runs on the
    # true image extent
    prior_planes, prior_mask = build_planar_prior(
        ref.cam, out.depth[:h, :w], out.cost[:h, :w], dmin, dmax, w, h,
    )
    if cfg.debug_images and rdir is not None:
        # triangulation debug image (the reference writes triangulation.png
        # per view, acmmp_definitions.cpp:329): white = pixels covered by a
        # valid triangulated prior plane
        from PIL import Image as PILImage

        mask_img = (np.zeros((h, w), np.uint8) if prior_mask is None
                    else (prior_mask[:h, :w] * 255).astype(np.uint8))
        mh.on_primary(PILImage.fromarray(mask_img).save,
                      os.path.join(rdir, "triangulation.png"))
    if prior_planes is None:
        return None
    inputs2 = build_solver_inputs(
        ref.image, [s.image for s in prep.srcs], ref.cam,
        [s.cam for s in prep.srcs], params, num_views_pad=prep.v_pad,
        pad_h=prep.pad_h, pad_w=cfg.pad_w,
        init_depth=out.depth, init_normal_world=out.normal_world,
        init_cost=out.cost, prior_planes=prior_planes,
        prior_mask=prior_mask,
        pre_costs=out.pre_costs if hierarchy else None,
        src_depths=prep.src_depths, device=device,
    )
    if prep.src_depths is None and prep.inputs.src_depths is not None:
        # a tiled view on a mesh: the first solve's source depths came
        # from the pass's bank (already padded [Vp, Hs, Ws]); reuse that
        # tensor instead of reading the files. A batched view on a mesh
        # gathers them from the bank again (BatchedSolver's depth_bank)
        inputs2 = inputs2._replace(src_depths=prep.inputs.src_depths)
    return inputs2


def _problem_key(cfg, rid, pass_tag):
    return keys.fold_in(keys.key(cfg.seed), rid * 131 + pass_tag)


def _prior_size_skip(cfg, prep) -> bool:
    """True when cfg.planar_prior_max_pixels bounds the planar-prior
    second solve away from this (large) view."""
    return (cfg.planar_prior_max_pixels > 0
            and prep.h * prep.w > cfg.planar_prior_max_pixels)


def _write_pass(output_folder: str, pp: _Prepared, out: SolverOutputs,
                pass_tag: int, geom_consistency: bool, desc: str) -> None:
    """A solved view's .dmb files, pass marker and stage metrics."""
    rid = pp.problem.ref_image_id
    _write_outputs(result_dir(output_folder, rid), out, pp.h, pp.w,
                   geom_consistency)
    _mark_pass_done(output_folder, rid, pass_tag, pp.problem.cur_image_size,
                    desc)
    stage_metrics(log, f"view {rid:08d}", out.depth[:pp.h, :pp.w],
                  out.cost[:pp.h, :pp.w])


def process_batch(
    dense_folder: str,
    output_folder: str,
    problems: Sequence[Problem],
    indices: Sequence[int],
    cfg: PipelineConfig,
    loader: ViewLoader,
    solver: BatchedSolver,
    *,
    geom_consistency: bool,
    planar_prior: bool,
    hierarchy: bool,
    multi_geometry: bool = False,
    seeded: bool = False,
    pass_tag: int = 0,
    device=None,
    depth_cache: Optional[dict] = None,
) -> None:
    """The (view, scale, mode) solves of the views `indices`, each with its
    optional planar-prior second solve (ProcessProblem,
    acmmp_definitions.cpp:245-403), on `device` (CUDA unless told
    otherwise) or over `solver.mesh`: the JAX package's process_batch.
    Every view not done on resume is prepared first, then the views are
    grouped by static shape (tiled views apart), each group solved as one
    batch (or, tiled, view by view with its rows over the mesh), the
    planar-prior second solve batched over the group's views whose
    triangulation gave priors (the reference skips the second solve for
    the rest, acmmp_definitions.cpp:318-330), and only then are each
    view's .dmb files and pass marker written. A chunk of one view is the
    reference's one-view solve.

    On a mesh, a geometric pass's source depth maps come from the pass's
    bank (_src_depth_banks) instead of per-problem disk reads (the
    reference's round trip, src/ACMMP.cpp:608-635): each member gathers
    its problems' maps onto its own device. Pass one `depth_cache` dict
    to every batch of a pass so that each view's map is read once per
    pass."""
    dev = runtime.resolve_device(device)
    mesh = solver.mesh
    collective = mesh is not None and geom_consistency
    tile_devices = 0 if mesh is None else len(mesh)
    if cfg.resume:
        done = [i for i in indices
                if _pass_done(output_folder, problems[i].ref_image_id,
                              pass_tag, problems[i].cur_image_size)]
        for i in done:
            log.info("resume: view %08d pass %d already done; skipping",
                     problems[i].ref_image_id, pass_tag)
        indices = [i for i in indices if i not in done]
    preps: List[_Prepared] = []
    for i in indices:
        p = _prepare_problem(
            dense_folder, output_folder, problems, i, cfg, loader, dev,
            geom_consistency=geom_consistency, hierarchy=hierarchy,
            multi_geometry=multi_geometry, seeded=seeded,
            skip_src_depth_files=collective, tile_devices=tile_devices)
        if p is not None:
            preps.append(p)
    mode = Mode(geom_consistency=geom_consistency, hierarchy=hierarchy,
                seeded=seeded)
    desc = _mode_desc(geom_consistency, hierarchy, seeded, multi_geometry)

    # group by static shape so each group stacks; tiled views (rows
    # sharded over the mesh) group apart
    groups: Dict[tuple, List[_Prepared]] = {}
    for pp in preps:
        shape = (tuple(pp.inputs.ref_img.shape),
                 tuple(pp.inputs.src_imgs.shape), pp.tiled)
        groups.setdefault(shape, []).append(pp)

    banks = (_src_depth_banks(groups, problems, output_folder, mesh,
                              multi_geometry, cache=depth_cache)
             if collective else {})

    def solve_group(inputs, ks, m, tiled, bank):
        if not tiled:                 # a batch, sharded over a mesh
            return solver.solve_batch(inputs, ks, m, depth_bank=bank)
        # tiled: each view's rows over every member, views one after
        # another (one large view is the whole step's work)
        return [tile_ops.tile_sharded_patchmatch(mesh, inp, k,
                                                 cfg.patchmatch, m)
                for inp, k in zip(inputs, ks)]

    for gkey, group in groups.items():
        tiled, bank = gkey[2], banks.get(gkey)
        ks = [_problem_key(cfg, pp.problem.ref_image_id, pass_tag)
              for pp in group]
        outs = [_on_host(o) for o in solve_group(
            [pp.inputs for pp in group], ks, mode, tiled, bank)]
        if planar_prior:
            second = []
            for j, (pp, out) in enumerate(zip(group, outs)):
                if _prior_size_skip(cfg, pp):
                    continue
                inputs2 = _prior_second_solve_inputs(
                    pp, out, cfg, hierarchy, dev,
                    rdir=result_dir(output_folder, pp.problem.ref_image_id))
                if inputs2 is not None:
                    second.append((j, inputs2))
            if second:
                mode2 = Mode(geom_consistency=geom_consistency,
                             planar_prior=True, hierarchy=hierarchy)
                rows = [j for j, _ in second]
                outs2 = solve_group(
                    [inp for _, inp in second],
                    [keys.fold_in(ks[j], 1) for j in rows], mode2, tiled,
                    None if bank is None else (bank[0], bank[1][rows]))
                for j, o2 in zip(rows, outs2):
                    outs[j] = _on_host(o2)
        for pp, out in zip(group, outs):
            _write_pass(output_folder, pp, out, pass_tag, geom_consistency,
                        desc)


def _src_depth_banks(groups, problems, output_folder, mesh: Mesh,
                     multi_geometry, cache=None) -> dict:
    """The source depth maps of a geometric pass on a mesh, through the
    pass's bank: every view's OWN current depth map is read once into the
    bank (one read per view per pass), member m holding its chunk of it:
    each process reads its own members' chunks only, the others' come
    through the all-gather (parallel.sharding.gather_bank).
    Returns {group key: (the bank's member shards, src_idx [b, V])} for
    each batched group: BatchedSolver gives every member the whole bank
    and a local integer gather picks its problems' sources on its device
    (parallel.sharding.view_sharded_geometric_solve). A tiled group's
    problems get their source maps attached on their own device instead,
    since every member of a tiled solve reads a view's whole sources; so
    do problems with a source outside the view set, read from disk.

    `cache` (a dict owned by the caller, one per geometric pass) holds
    the raw maps and the per-bucket banks, so neither is rebuilt across
    shape buckets or batches: depth files do not change within a pass."""
    suffix = "depths_geom.dmb" if multi_geometry else "depths.dmb"
    id2idx = {p.ref_image_id: k for k, p in enumerate(problems)}
    n_mesh = len(mesh)
    if cache is None:
        cache = {}

    def raw_map(rid):
        key = ("raw", rid)
        if key not in cache:
            try:
                cache[key] = read_dmb(os.path.join(
                    result_dir(output_folder, rid), suffix))
            except FileNotFoundError:
                # a view that never solved (sourceless) can still be
                # someone's source; a zero map marks its depths invalid
                # (sd <= 0 -> geom_cost_max, ops/geom.py)
                cache[key] = None
        return cache[key]

    def bank_for(hs, ws):
        # every view's own current map at this bucket's padded shape, the
        # shards of this process's members (None for the others'). A view
        # larger than the bucket, or a padding row, is zeroed: a problem's
        # bucket shape is at least each of its sources' true sizes, so
        # this bucket never gathers that slot
        key = ("bank", hs, ws)
        if key not in cache:
            n = len(problems) + (-len(problems) % n_mesh)

            def slot(k):
                d = (raw_map(problems[k].ref_image_id)
                     if k < len(problems) else None)
                if d is None or d.shape[0] > hs or d.shape[1] > ws:
                    return np.zeros((hs, ws), np.float32)
                return _pad_to(d, hs, ws)
            shards = [None] * n_mesh
            for m in mesh.local():
                rows = member_rows(n, n_mesh, m)
                shards[m] = torch.as_tensor(np.stack([
                    slot(k) for k in range(rows.start, rows.stop)]),
                    device=mesh[m])
            cache[key] = shards
        return cache[key]

    def disk_read(pp, hs, ws):
        depths = np.stack([
            _pad_to(read_dmb(os.path.join(
                result_dir(output_folder, s), suffix)), hs, ws)
            for s in pp.problem.src_image_ids] + [
            np.zeros((hs, ws), np.float32)] * (
                pp.v_pad - len(pp.problem.src_image_ids)))
        pp.inputs = pp.inputs._replace(src_depths=torch.as_tensor(
            depths, device=pp.inputs.ref_img.device))

    banks = {}
    for gkey, group in groups.items():
        hs, ws = group[0].inputs.src_imgs.shape[-2:]
        if not all(s in id2idx for pp in group
                   for s in pp.problem.src_image_ids):
            log.info("geom collective unavailable for a %dx%d group; "
                     "reading source depths from disk", hs, ws)
            for pp in group:
                disk_read(pp, hs, ws)
            continue
        si = torch.zeros((len(group), group[0].v_pad), dtype=torch.int64)
        for j, pp in enumerate(group):
            ids = [id2idx[s] for s in pp.problem.src_image_ids]
            si[j, :len(ids)] = torch.as_tensor(ids)
        bank = bank_for(hs, ws)
        if not group[0].tiled:
            banks[gkey] = (bank, si)
            continue
        dev = group[0].inputs.ref_img.device
        full = torch.cat([b.to(dev) for b in gather_bank(mesh, bank)])
        for j, pp in enumerate(group):
            pp.inputs = pp.inputs._replace(src_depths=full[si[j].to(dev)])
    return banks


def _pad_to(a: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.pad(np.asarray(a, np.float32),
                  ((0, h - a.shape[0]), (0, w - a.shape[1])))


def joint_bilateral_upsampling(dense_folder: str, output_folder: str,
                               problem: Problem, acmmp_size: int,
                               cfg: PipelineConfig, loader: ViewLoader,
                               device=None) -> None:
    """Upsample depths_geom.dmb to the next scale via JBU on `device` and
    store it as the next scale's depths.dmb (JointBilateralUpsampling,
    acmmp_definitions.cpp:405-440): on rank 0 only, which writes it."""
    dev = runtime.resolve_device(device)
    rid = problem.ref_image_id
    rdir = result_dir(output_folder, rid)
    coarse = read_dmb(os.path.join(rdir, "depths_geom.dmb"))
    fine = loader.at_size(rid, acmmp_size)
    if max(fine.image.shape[0] // coarse.shape[0],
           fine.image.shape[1] // coarse.shape[1]) <= 1:
        return  # RunJBU: "Image.rows = Depthmap.rows" early-out
    if not mh.is_primary():
        return
    up = jbu_depth(torch.as_tensor(fine.image, device=dev),
                   torch.as_tensor(coarse, device=dev), cfg.patchmatch)
    mh.on_primary(write_dmb, os.path.join(rdir, "depths.dmb"),
                  up.cpu().numpy())


def run_pipeline(dense_folder: str, cfg: PipelineConfig, device=None,
                 mesh: Optional[Mesh] = None) -> str:
    """Full reconstruction: the reference CLI main (main_ACMMP.cpp:9-198)
    on one device (CUDA unless told otherwise) or over a device `mesh`
    (parallel/sharding.make_view_mesh). Returns the written PLY path.
    Each pass solves its views in chunks of cfg.view_batch problems (at
    least the mesh size on a mesh) through the batched executor
    (process_batch; chunks of one view by default). On a mesh the host's
    device work (input staging, JBU) runs on this process's first member
    unless `device` names another. Every stage logs its wall time; set
    ACMMP_TPU_PROFILE=<dir> for a torch.profiler trace of each. The last
    line logs this process's rank, the files it wrote and its kernel
    launches."""
    if cfg.view_batch < 1:
        raise ValueError(f"view_batch must be at least 1, not "
                         f"{cfg.view_batch}")
    if mesh is not None and device is None:
        device = mesh[mesh.local()[0]]
    dev = runtime.resolve_device(device)
    t_start = time.time()
    n_solves = 0
    problems = generate_sample_list(dense_folder)
    solver = BatchedSolver(cfg.patchmatch, mesh)

    def run_views(**mode_kw):
        b = cfg.view_batch if mesh is None else max(cfg.view_batch,
                                                    len(mesh))
        # one depth-bank cache per pass: depth files do not change
        # within a pass
        depth_cache: dict = {}
        for start in range(0, len(problems), b):
            process_batch(dense_folder, output_folder, problems,
                          list(range(start, min(start + b, len(problems)))),
                          cfg, loader, solver, device=dev,
                          depth_cache=depth_cache, **mode_kw)
        # the next pass reads this pass's files, which rank 0 wrote
        mh.barrier(f"pass_{mode_kw['pass_tag']}")

    log.info("There are %d problems to process", len(problems))
    max_num_downscale = compute_multiscale_settings(
        dense_folder, problems, cfg.patchmatch, cfg.image_dir)

    prior = cfg.use_prior
    if prior and not priors_available(dense_folder, len(problems)):
        raise FileNotFoundError(
            "seeded init requested (--prior) but priors/ not found")

    out_name = cfg.output_dir
    if prior and cfg.output_dir == "ACMMP":
        out_name = "ACMMP_PRIOR"
    output_folder = os.path.join(dense_folder, out_name)
    os.makedirs(output_folder, exist_ok=True)
    loader = ViewLoader(dense_folder, cfg.image_dir)

    tag = 0
    first_scale = True
    scale = max_num_downscale
    while scale >= 0:
        log.info("Scale: %d", scale)
        for p in problems:
            if p.num_downscale >= 0:
                p.cur_image_size = p.max_image_size // (2 ** p.num_downscale)
                p.num_downscale -= 1

        if first_scale:
            first_scale = False
            with profiled(f"photometric_s{scale}"):
                run_views(geom_consistency=False,
                          planar_prior=cfg.planar_prior,
                          hierarchy=False, seeded=prior, pass_tag=tag)
            n_solves += len(problems)
            tag += 1
        else:
            log.info("Starting JBU")
            with profiled(f"jbu_s{scale}"):
                for p in problems:
                    # on resume, a completed hierarchy solve (next pass,
                    # tag) must not have its depths.dmb re-clobbered by
                    # JBU of the coarse depths_geom.dmb — skip JBU for
                    # those views
                    if cfg.resume and _pass_done(output_folder,
                                                 p.ref_image_id, tag,
                                                 p.cur_image_size):
                        continue
                    joint_bilateral_upsampling(
                        dense_folder, output_folder, p, p.cur_image_size,
                        cfg, loader, device=dev)
            mh.barrier(f"jbu_s{scale}")
            with profiled(f"hierarchy_s{scale}"):
                run_views(geom_consistency=False,
                          planar_prior=cfg.planar_prior,
                          hierarchy=True, pass_tag=tag)
            n_solves += len(problems)
            tag += 1
        for geom_iter in range(cfg.geom_iterations):
            with profiled(f"geometric_s{scale}_i{geom_iter}"):
                run_views(geom_consistency=True, planar_prior=False,
                          hierarchy=False, multi_geometry=geom_iter > 0,
                          pass_tag=tag)
            n_solves += len(problems)
            tag += 1
        scale -= 1

    fusion_folder = os.path.join(dense_folder, cfg.fusion_dir)
    fusion_counts: Dict[int, int] = {}

    def fusion_progress(rid, n_accepted):
        fusion_counts[rid] = n_accepted
        log.info("fusion view %08d: %d points accepted", rid, n_accepted)

    debug_dir = output_folder if cfg.debug_images else None
    with profiled("fusion"):
        if (prior and cfg.multi_fusion) or cfg.force_fusion:
            ply = run_prior_aware_fusion(
                dense_folder, output_folder, fusion_folder, problems,
                geom_consistency=True, fp=cfg.fusion,
                single_match_penalty=cfg.fusion.single_match_penalty,
                mask_dir=cfg.mask_dir, progress=fusion_progress,
                debug_dir=debug_dir, view_cache=cfg.fusion_view_cache,
                device=dev, mesh=mesh,
            )
        else:
            ply = run_fusion(
                dense_folder, output_folder, problems, geom_consistency=True,
                fp=cfg.fusion, image_dir=cfg.image_dir,
                mask_dir=cfg.mask_dir, progress=fusion_progress,
                debug_dir=debug_dir, view_cache=cfg.fusion_view_cache,
                device=dev, mesh=mesh,
            )
    if fusion_counts:
        total = sum(fusion_counts.values())
        log.info("fusion: %d points from %d views (min %d / median %d / "
                 "max %d per view)", total, len(fusion_counts),
                 min(fusion_counts.values()),
                 int(np.median(list(fusion_counts.values()))),
                 max(fusion_counts.values()))
    elapsed = time.time() - t_start
    log.info("wrote %s", ply)
    # the BASELINE throughput metric: depth-map solves per second
    log.info("pipeline: %d solves in %.1fs (%.3f depth-maps/s)",
             n_solves, elapsed, n_solves / max(elapsed, 1e-9))
    log.info("rank %d of %d: %d files written; launches zncc %d, geom %d, "
             "sample %d", mh.rank(), mh.world_size(), mh.files_written,
             cuda_ncc.total_launches(), cuda_geom.total_launches(),
             cuda_sample.total_launches())
    return ply
