"""Multi-scale reconstruction scheduler — the port of
``acmmp_tpu/pipeline/scheduler.py`` (its one-view-at-a-time path).

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
device (CUDA unless told otherwise); images, priors and checkpoints stay
on the host between stages. The batched executor (``view_batch > 1``) and
the mesh paths are not ported (ROADMAP Queue 1 items 3 and 6)."""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import OrderedDict
from typing import Dict, List, Sequence

import numpy as np
import torch

from acmmp_tpu_torch import runtime
from acmmp_tpu_torch.config import PatchMatchParams, PipelineConfig
from acmmp_tpu_torch.engine.fusion import run_fusion, run_prior_aware_fusion
from acmmp_tpu_torch.engine.inputs import build_solver_inputs
from acmmp_tpu_torch.engine.patchmatch import (Mode, SolverOutputs,
                                               run_patchmatch)
from acmmp_tpu_torch.engine.priors import build_planar_prior
from acmmp_tpu_torch.io import read_dmb, write_dmb
from acmmp_tpu_torch.io.dense_folder import (
    Problem, cam_path, image_path, load_image_gray, read_cam_txt,
    read_pair_txt, rescale_to_max_size, result_dir,
)
from acmmp_tpu_torch.io.priors import load_seed_planes, priors_available
from acmmp_tpu_torch.ops import keys
from acmmp_tpu_torch.ops.jbu import jbu_depth, jbu_normal_cost
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
    with open(_pass_marker_path(output_folder, rid, tag), "w") as f:
        json.dump({"size": size, "pass": desc}, f)


def _on_host(out: SolverOutputs) -> SolverOutputs:
    return SolverOutputs(*(t.cpu().numpy() for t in out))


def _write_outputs(rdir: str, out: SolverOutputs, h: int, w: int,
                   geom: bool) -> None:
    os.makedirs(rdir, exist_ok=True)
    write_dmb(os.path.join(rdir, "depths_geom.dmb" if geom
                           else "depths.dmb"), out.depth[:h, :w])
    write_dmb(os.path.join(rdir, "normals.dmb"), out.normal_world[:h, :w])
    write_dmb(os.path.join(rdir, "costs.dmb"), out.cost[:h, :w])


class _Prepared:
    """Host-side loaded inputs of one (view, scale, mode) solve."""

    def __init__(self, problem, ref, srcs, inputs, h, w, v_pad, src_depths):
        self.problem = problem
        self.ref = ref
        self.srcs = srcs
        self.inputs = inputs
        self.h = h
        self.w = w
        self.v_pad = v_pad
        self.src_depths = src_depths


def _prepare_problem(dense_folder, output_folder, problems, idx, cfg,
                     loader, device, *, geom_consistency, hierarchy,
                     multi_geometry, seeded):
    """Disk -> SolverInputs on `device` for one problem
    (InputInitialization, src/ACMMP.cpp:525-636). Returns None for skipped
    (sourceless) views."""
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

    kw = {}
    suffix = "depths_geom.dmb" if multi_geometry else "depths.dmb"
    if geom_consistency:
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
        params, num_views_pad=v_pad, pad_h=cfg.pad_h, pad_w=cfg.pad_w,
        device=device, **kw,
    )
    return _Prepared(problem, ref, srcs, inputs, h, w, v_pad,
                     kw.get("src_depths"))


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
        PILImage.fromarray(mask_img).save(
            os.path.join(rdir, "triangulation.png"))
    if prior_planes is None:
        return None
    return build_solver_inputs(
        ref.image, [s.image for s in prep.srcs], ref.cam,
        [s.cam for s in prep.srcs], params, num_views_pad=prep.v_pad,
        pad_h=cfg.pad_h, pad_w=cfg.pad_w,
        init_depth=out.depth, init_normal_world=out.normal_world,
        init_cost=out.cost, prior_planes=prior_planes,
        prior_mask=prior_mask,
        pre_costs=out.pre_costs if hierarchy else None,
        src_depths=prep.src_depths, device=device,
    )


def _problem_key(cfg, rid, pass_tag):
    return keys.fold_in(keys.key(cfg.seed), rid * 131 + pass_tag)


def _prior_size_skip(cfg, prep) -> bool:
    """True when cfg.planar_prior_max_pixels bounds the planar-prior
    second solve away from this (large) view."""
    return (cfg.planar_prior_max_pixels > 0
            and prep.h * prep.w > cfg.planar_prior_max_pixels)


def process_problem(
    dense_folder: str,
    output_folder: str,
    problems: Sequence[Problem],
    idx: int,
    cfg: PipelineConfig,
    loader: ViewLoader,
    *,
    geom_consistency: bool,
    planar_prior: bool,
    hierarchy: bool,
    multi_geometry: bool = False,
    seeded: bool = False,
    pass_tag: int = 0,
    device=None,
) -> None:
    """One (view, scale, mode) solve + optional planar-prior second solve
    (ProcessProblem, acmmp_definitions.cpp:245-403), on `device` (CUDA
    unless told otherwise)."""
    dev = runtime.resolve_device(device)
    params = cfg.patchmatch
    if cfg.resume and _pass_done(output_folder,
                                 problems[idx].ref_image_id, pass_tag,
                                 problems[idx].cur_image_size):
        log.info("resume: view %08d pass %d already done; skipping",
                 problems[idx].ref_image_id, pass_tag)
        return
    prep = _prepare_problem(
        dense_folder, output_folder, problems, idx, cfg, loader, dev,
        geom_consistency=geom_consistency, hierarchy=hierarchy,
        multi_geometry=multi_geometry, seeded=seeded)
    if prep is None:
        return
    rid = prep.problem.ref_image_id
    rdir = result_dir(output_folder, rid)
    mode = Mode(geom_consistency=geom_consistency, hierarchy=hierarchy,
                seeded=seeded)
    key = _problem_key(cfg, rid, pass_tag)
    out = _on_host(run_patchmatch(prep.inputs, key, params, mode))

    if planar_prior and not _prior_size_skip(cfg, prep):
        inputs2 = _prior_second_solve_inputs(prep, out, cfg, hierarchy, dev,
                                             rdir=rdir)
        if inputs2 is not None:
            mode2 = Mode(geom_consistency=geom_consistency,
                         planar_prior=True, hierarchy=hierarchy)
            out = _on_host(run_patchmatch(inputs2, keys.fold_in(key, 1),
                                          params, mode2))

    _write_outputs(rdir, out, prep.h, prep.w, geom_consistency)
    _mark_pass_done(output_folder, rid, pass_tag,
                    prep.problem.cur_image_size,
                    _mode_desc(geom_consistency, hierarchy, seeded,
                               multi_geometry))
    stage_metrics(log, f"view {rid:08d}", out.depth[:prep.h, :prep.w],
                  out.cost[:prep.h, :prep.w])


def joint_bilateral_upsampling(dense_folder: str, output_folder: str,
                               problem: Problem, acmmp_size: int,
                               cfg: PipelineConfig, loader: ViewLoader,
                               device=None) -> None:
    """Upsample depths_geom.dmb to the next scale via JBU on `device` and
    store it as the next scale's depths.dmb (JointBilateralUpsampling,
    acmmp_definitions.cpp:405-440)."""
    dev = runtime.resolve_device(device)
    rid = problem.ref_image_id
    rdir = result_dir(output_folder, rid)
    coarse = read_dmb(os.path.join(rdir, "depths_geom.dmb"))
    fine = loader.at_size(rid, acmmp_size)
    if max(fine.image.shape[0] // coarse.shape[0],
           fine.image.shape[1] // coarse.shape[1]) <= 1:
        return  # RunJBU: "Image.rows = Depthmap.rows" early-out
    up = jbu_depth(torch.as_tensor(fine.image, device=dev),
                   torch.as_tensor(coarse, device=dev), cfg.patchmatch)
    write_dmb(os.path.join(rdir, "depths.dmb"), up.cpu().numpy())


def run_pipeline(dense_folder: str, cfg: PipelineConfig,
                 device=None) -> str:
    """Full reconstruction: the reference CLI main (main_ACMMP.cpp:9-198)
    on one device (CUDA unless told otherwise). Returns the written PLY
    path. Every stage logs its wall time; set ACMMP_TPU_PROFILE=<dir> for
    a torch.profiler trace of each."""
    if cfg.view_batch > 1:
        raise NotImplementedError(
            "view_batch > 1 (the batched executor) is not ported yet: "
            "ROADMAP Queue 1 items 3 and 6")
    dev = runtime.resolve_device(device)
    t_start = time.time()
    n_solves = 0
    problems = generate_sample_list(dense_folder)

    def run_views(**mode_kw):
        for i in range(len(problems)):
            process_problem(dense_folder, output_folder, problems, i, cfg,
                            loader, device=dev, **mode_kw)

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
                device=dev,
            )
        else:
            ply = run_fusion(
                dense_folder, output_folder, problems, geom_consistency=True,
                fp=cfg.fusion, image_dir=cfg.image_dir,
                mask_dir=cfg.mask_dir, progress=fusion_progress,
                debug_dir=debug_dir, view_cache=cfg.fusion_view_cache,
                device=dev,
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
    return ply
