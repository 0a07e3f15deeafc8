"""Command-line interface of the PyTorch/CUDA port — the ``reconstruct``
and ``fuse`` subcommands of ``acmmp_tpu/cli.py``:

  reconstruct    ./ACMMP <dense_folder> ...        (main_ACMMP.cpp:9-198)
  fuse           ./fuse_data <dense_folder> ...    (main_fusion.cpp:7-95)

    python -m acmmp_tpu_torch.cli reconstruct <dense_folder> [--device cpu]

Both run on CUDA unless ``--device`` says otherwise. ``--view_batch N``
solves N reference views per launch stream (pipeline/batched.py). The
other subcommands of the JAX package and ``--mesh`` are not ported yet
(ROADMAP Queue 1 items 4 and 6)."""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from acmmp_tpu_torch.config import (FusionParams, PatchMatchParams,
                                    PipelineConfig)


def _add_common_flags(p: argparse.ArgumentParser):
    p.add_argument("dense_folder", help="input dense folder")
    p.add_argument("--fuse_thresh", "-f", type=float, default=0.3,
                   help="average inverse score threshold for fusion")
    p.add_argument("--multi_fusion", nargs="?", const="ACMMP", default=None,
                   help="use a previous reconstruction during fusion")
    p.add_argument("--force_fusion", action="store_true",
                   help="force multi fusion, without prior")
    p.add_argument("--output_dir", default="ACMMP")
    p.add_argument("--num_consistent_thresh", type=int, default=1)
    p.add_argument("--single_match_penalty", type=int, default=0)
    p.add_argument("--mask_dir", default=None,
                   help="directory of boolean masks (0, 255)")
    p.add_argument("--image_override", default="images",
                   help="alternative image directory for fusion colors")
    p.add_argument("--fusion_view_cache", type=int, default=0,
                   help="keep at most N views' arrays resident during "
                        "fusion (lazy LRU loading); 0 = load all up front")
    p.add_argument("--device", default="cuda",
                   help="torch device the solves and fusion run on "
                        "(default cuda; cpu runs the plain versions)")


def _cfg_from_args(args, prior: bool) -> PipelineConfig:
    return PipelineConfig(
        output_dir=args.output_dir,
        fusion_dir=args.multi_fusion or "ACMMP",
        mask_dir=args.mask_dir,
        image_dir=args.image_override,
        use_prior=prior,
        multi_fusion=args.multi_fusion is not None,
        force_fusion=args.force_fusion,
        seed=getattr(args, "seed", 0),
        debug_images=getattr(args, "debug_images", False),
        resume=getattr(args, "resume", False),
        fusion_view_cache=args.fusion_view_cache,
        patchmatch=PatchMatchParams(
            max_image_size=getattr(args, "max_image_size", 3200),
            rand_depth_tile_window=getattr(
                args, "rand_depth_window",
                PatchMatchParams.rand_depth_tile_window),
            rand_normal_min_cos=getattr(
                args, "rand_normal_cos",
                PatchMatchParams.rand_normal_min_cos),
        ),
        fusion=FusionParams(
            consistency_scalar=args.fuse_thresh,
            num_consistent_thresh=args.num_consistent_thresh,
            single_match_penalty=args.single_match_penalty,
        ),
    )


def main(argv=None):
    parser = argparse.ArgumentParser(prog="acmmp-tpu-torch",
                                     description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("reconstruct", help="full multi-scale reconstruction")
    _add_common_flags(pr)
    pr.add_argument("--prior", "-p", action="store_true",
                    help="seed initialization from priors/")
    pr.add_argument("--seed", type=int, default=0, help="RNG seed")
    pr.add_argument("--max_image_size", type=int, default=3200)
    pr.add_argument("--no_planar_prior", action="store_true")
    pr.add_argument("--planar_prior_max_pixels", type=int, default=0,
                    help="skip the planar-prior second solve for views "
                         "larger than this many pixels (0 = no bound)")
    pr.add_argument("--view_batch", type=int, default=1,
                    help="reference views solved per launch stream "
                         "(the batched executor)")
    pr.add_argument("--debug_images", action="store_true",
                    help="write approved_pixels_cam_N.png and "
                         "triangulation.png debug artifacts")
    pr.add_argument("--rand_depth_window", type=float,
                    default=PatchMatchParams.rand_depth_tile_window,
                    help="draw random depths inside a per-(16,128)-tile "
                         "random subrange of this fraction of the depth "
                         "range (the JAX package's default deviation, "
                         "DEVIATIONS.md #18); 0 = exact reference semantics")
    pr.add_argument("--rand_normal_cos", type=float,
                    default=PatchMatchParams.rand_normal_min_cos,
                    help="draw random normals on the spherical cap "
                         "dot(n, -view_dir) >= c instead of the full facing "
                         "hemisphere (DEVIATIONS.md #19); 0 = exact "
                         "reference law")
    pr.add_argument("--resume", action="store_true",
                    help="skip (view, scale, mode) solves already completed "
                         "by a previous run (stage markers next to the .dmb "
                         "outputs)")

    pf = sub.add_parser("fuse", help="fusion only, from existing .dmb outputs")
    _add_common_flags(pf)
    pf.add_argument("--geom", action="store_true",
                    help="fuse depths_geom.dmb instead of depths.dmb "
                         "(the reference fusion binary always uses "
                         "depths.dmb)")

    args = parser.parse_args(argv)

    # friendly dense-folder validation (the reference segfault-exits on a
    # missing folder; we fail with a clear message before any work)
    dense = args.dense_folder
    if not os.path.isdir(dense):
        parser.error(f"dense folder not found: {dense}")
    if not os.path.exists(os.path.join(dense, "pair.txt")):
        parser.error(
            f"{dense} is not a dense folder (missing pair.txt — expected "
            "the images/ cams/ pair.txt contract)")

    if args.cmd == "reconstruct":
        from acmmp_tpu_torch.pipeline.scheduler import run_pipeline

        cfg = _cfg_from_args(args, prior=args.prior)
        if args.no_planar_prior:
            cfg = dataclasses.replace(cfg, planar_prior=False)
        if args.planar_prior_max_pixels:
            cfg = dataclasses.replace(
                cfg, planar_prior_max_pixels=args.planar_prior_max_pixels)
        if args.view_batch > 1:
            cfg = dataclasses.replace(cfg, view_batch=args.view_batch)
        ply = run_pipeline(dense, cfg, device=args.device)
    else:
        from acmmp_tpu_torch.engine.fusion import (run_fusion,
                                                   run_prior_aware_fusion)
        from acmmp_tpu_torch.pipeline.scheduler import generate_sample_list

        cfg = _cfg_from_args(args, prior=False)
        problems = generate_sample_list(dense)
        out_folder = os.path.join(dense, cfg.output_dir)
        if cfg.multi_fusion or cfg.force_fusion:
            ply = run_prior_aware_fusion(
                dense, out_folder, os.path.join(dense, cfg.fusion_dir),
                problems, geom_consistency=args.geom, fp=cfg.fusion,
                single_match_penalty=cfg.fusion.single_match_penalty,
                mask_dir=cfg.mask_dir, view_cache=cfg.fusion_view_cache,
                device=args.device,
            )
        else:
            ply = run_fusion(
                dense, out_folder, problems, geom_consistency=args.geom,
                fp=cfg.fusion, image_dir=cfg.image_dir,
                mask_dir=cfg.mask_dir, view_cache=cfg.fusion_view_cache,
                device=args.device,
            )
    print(ply)
    return 0


if __name__ == "__main__":
    sys.exit(main())
