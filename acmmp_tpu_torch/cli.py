"""Command-line interface of the PyTorch/CUDA port.

Its subcommands are those of ``acmmp_tpu/cli.py``, which mirror the
reference's executables and scripts:

  reconstruct    ./ACMMP <dense_folder> ...        (main_ACMMP.cpp:9-198)
  fuse           ./fuse_data <dense_folder> ...    (main_fusion.cpp:7-95)
  convert-colmap colmap2mvsnet_acm.py
  eval-dtu       matlab_analysis/dtu eval          (eval/dtu.py)
  select-cams    select_dtu_cams.py
  make-priors    run_dtu_analysis.py's prior sampling (public equivalent)
  analyze-dtu    run_dtu_analysis.py / evaluate_dtu_structure.py
  display-cams   display_dtu_cams.py (needs matplotlib)
  make-synthetic make_alex.py / make_blank_random.py fixtures

    python -m acmmp_tpu_torch.cli reconstruct <dense_folder> [--device cpu]

The subcommands that solve (``reconstruct``, ``fuse``, ``analyze-dtu``)
run on CUDA unless ``--device`` says otherwise; the others are host code.
``--view_batch N`` solves N reference views per launch stream
(pipeline/batched.py). ``reconstruct --mesh`` shards each batch of views
over every visible CUDA device, and the rows of a view above
``tile_pixels`` (parallel/); it raises without a CUDA device. Under the
variables ``torchrun`` sets it runs one process per host or card, all of
them one global mesh (parallel/multihost.py), rank 0 writing:

    torchrun --nproc_per_node=2 -m acmmp_tpu_torch.cli reconstruct <dense> --mesh

A mesh of a repeated device is built in code
(parallel.make_view_mesh(devices=...)), not on the command line."""

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
    _device_flag(p)


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


def _device_flag(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="torch device the solves and fusion run on "
                        "(default cuda; cpu runs the plain versions)")


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
                         "(the batched executor); --mesh shards the "
                         "batch over all local devices")
    pr.add_argument("--mesh", action="store_true",
                    help="shard view batches over a device mesh: every "
                         "visible CUDA device (raises without one; "
                         "--device is then not used); under torchrun, "
                         "each process's share of its host's devices, "
                         "all processes one mesh")
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

    pc = sub.add_parser("convert-colmap",
                        help="COLMAP sparse model -> dense folder")
    pc.add_argument("--dense_folder", required=True)
    pc.add_argument("--save_folder", required=True)
    pc.add_argument("--max_d", type=int, default=192)
    pc.add_argument("--interval_scale", type=float, default=1.0)
    pc.add_argument("--model_ext", default=".txt", choices=[".txt", ".bin"])

    pe = sub.add_parser("eval-dtu", help="DTU accuracy/completeness of a PLY")
    pe.add_argument("ply")
    pe.add_argument("--gt", required=True, help="ground-truth PLY/STL points")
    pe.add_argument("--dst", type=float, default=0.2,
                    help="down-sample density (official protocol: 0.2)")
    pe.add_argument("--max_dist", type=float, default=60.0)
    pe.add_argument("--sampleset", default=None,
                    help="official DTU SampleSet root (with ObsMask/); "
                         "enables observability + table-plane masking")
    pe.add_argument("--scan", type=int, default=None,
                    help="scan number for --sampleset mask lookup")
    pe.add_argument("--json", action="store_true")

    ps = sub.add_parser("select-cams",
                        help="build a reduced dense folder from a camera "
                             "subset (select_dtu_cams equivalent)")
    ps.add_argument("src")
    ps.add_argument("dst")
    ps.add_argument("--cams", required=True,
                    help="comma-separated source camera indices")
    ps.add_argument("--min_angle", type=float, default=3.0)
    ps.add_argument("--max_angle", type=float, default=120.0)
    ps.add_argument("--max_n_view", type=int, default=9)
    ps.add_argument("--seed", type=int, default=42)

    pp = sub.add_parser("make-priors",
                        help="render seeded-init priors from a fused PLY")
    pp.add_argument("dense_folder")
    pp.add_argument("--ply", required=True, help="point cloud to sample")

    pa = sub.add_parser("analyze-dtu",
                        help="DTU experiment grid: scans x camera subsets x "
                             "method variants (run_dtu_analysis equivalent)")
    pa.add_argument("scans_root")
    pa.add_argument("out_root")
    pa.add_argument("--cam_counts", default="2,3,5,9")
    pa.add_argument("--gt_root", default=None,
                    help="dir of <scan>.ply ground-truth clouds; enables "
                         "metric scoring + paired stats")
    pa.add_argument("--plot_dir", default=None,
                    help="write metric plots here (needs --gt_root and "
                         "matplotlib)")
    _device_flag(pa)

    pd = sub.add_parser("display-cams",
                        help="3D plot of camera poses (+ optional cloud) "
                             "to a PNG (display_dtu_cams equivalent; needs "
                             "matplotlib)")
    pd.add_argument("dense_folder")
    pd.add_argument("--out", default="cams.png")
    pd.add_argument("--ply", default=None)

    pm = sub.add_parser("make-synthetic",
                        help="write a synthetic plane dense folder "
                             "(make_alex equivalent fixture)")
    pm.add_argument("dst")
    pm.add_argument("--n_views", type=int, default=4)
    pm.add_argument("--width", type=int, default=64)
    pm.add_argument("--height", type=int, default=48)
    pm.add_argument("--plane_z", type=float, default=5.0)
    pm.add_argument("--random_priors", action="store_true",
                    help="also write random prior PNGs "
                         "(make_blank_random equivalent)")
    pm.add_argument("--relief", action="store_true",
                    help="non-planar height-field surface instead of the "
                         "fronto-parallel plane")

    args = parser.parse_args(argv)

    # friendly dense-folder validation (the reference segfault-exits on a
    # missing folder; we fail with a clear message before any work)
    if args.cmd in ("reconstruct", "fuse"):
        dense = args.dense_folder
        if not os.path.isdir(dense):
            parser.error(f"dense folder not found: {dense}")
        if not os.path.exists(os.path.join(dense, "pair.txt")):
            parser.error(
                f"{dense} is not a dense folder (missing pair.txt — "
                "expected the images/ cams/ pair.txt contract; see "
                "convert-colmap / make-synthetic)")

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
        if args.mesh:
            from acmmp_tpu_torch.parallel import make_view_mesh
            from acmmp_tpu_torch.parallel.multihost import (
                maybe_init_distributed)

            maybe_init_distributed()   # several processes; no-op in one
            print(run_pipeline(dense, cfg, mesh=make_view_mesh()))
        else:
            print(run_pipeline(dense, cfg, device=args.device))
    elif args.cmd == "fuse":
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
    elif args.cmd == "convert-colmap":
        from acmmp_tpu_torch.io.colmap import convert_colmap

        convert_colmap(args.dense_folder, args.save_folder, args.max_d,
                       args.interval_scale, args.model_ext)
    elif args.cmd == "eval-dtu":
        import json

        from acmmp_tpu_torch.eval.dtu import evaluate_ply
        from acmmp_tpu_torch.io import read_ply

        gt_pts, _, _ = read_ply(args.gt)
        obs = None
        if args.sampleset is not None:
            if args.scan is None:
                parser.error("--sampleset requires --scan")
            from acmmp_tpu_torch.eval.obsmask import DtuObsMask

            obs = DtuObsMask.load(args.sampleset, args.scan)
        metrics = evaluate_ply(args.ply, gt_pts, dst=args.dst,
                               max_dist=args.max_dist, obs_mask=obs)
        if args.json:
            print(json.dumps(metrics))
        else:
            for k, v in metrics.items():
                print(f"{k}: {v:.4f}")
    elif args.cmd == "select-cams":
        from acmmp_tpu_torch.experiments.select_cams import (
            ReconParams, setup_from_source)

        cams = [int(c) for c in args.cams.split(",")]
        params = ReconParams(minangle=args.min_angle, maxangle=args.max_angle,
                             max_n_view=args.max_n_view)
        setup_from_source(cams, args.src, args.dst, params, seed=args.seed)
        print(args.dst)
    elif args.cmd == "make-priors":
        from acmmp_tpu_torch.experiments.prior_sampler import (
            write_priors_from_points)
        from acmmp_tpu_torch.io import read_ply
        from acmmp_tpu_torch.io.dense_folder import load_cams

        pts, _, _ = read_ply(args.ply)
        write_priors_from_points(args.dense_folder, pts,
                                 load_cams(args.dense_folder))
        print(os.path.join(args.dense_folder, "priors"))
    elif args.cmd == "analyze-dtu":
        import glob

        from acmmp_tpu_torch.eval.stats import paired_tests
        from acmmp_tpu_torch.experiments.dtu_analysis import (
            analyze_dtu_scans)
        from acmmp_tpu_torch.io import read_ply

        gt = None
        if args.gt_root:
            gt = {}
            for p in glob.glob(os.path.join(args.gt_root, "*.ply")):
                name = os.path.splitext(os.path.basename(p))[0]
                gt[name], _, _ = read_ply(p)
        table = analyze_dtu_scans(
            args.scans_root, args.out_root,
            cam_counts=[int(c) for c in args.cam_counts.split(",")],
            gt_points=gt, device=args.device)
        if gt:
            for metric in ("acc_median", "completeness_median"):
                for a, b, diff, p in paired_tests(table, metric):
                    print(f"{metric}: {a} vs {b}: mean diff {diff:+.4f} "
                          f"p_adj={p:.4f}")
            if args.plot_dir:
                from acmmp_tpu_torch.experiments.visualize import (
                    plot_metric_vs_cams)

                for metric in ("acc_median", "completeness_median"):
                    out = plot_metric_vs_cams(
                        table, metric,
                        os.path.join(args.plot_dir, f"{metric}.png"))
                    print(out)
    elif args.cmd == "display-cams":
        import glob

        from acmmp_tpu_torch.experiments.visualize import plot_cameras
        from acmmp_tpu_torch.io.dense_folder import read_cam_txt

        cams = [read_cam_txt(p) for p in sorted(
            glob.glob(os.path.join(args.dense_folder, "cams", "*_cam.txt")))]
        pts = None
        if args.ply:
            from acmmp_tpu_torch.io import read_ply

            pts, _, _ = read_ply(args.ply)
        print(plot_cameras(cams, args.out, points=pts))
    elif args.cmd == "make-synthetic":
        from acmmp_tpu_torch.experiments.fixtures import (
            write_random_priors, write_synthetic_dense_folder)

        write_synthetic_dense_folder(
            args.dst, n_views=args.n_views, width=args.width,
            height=args.height, plane_z=args.plane_z, relief=args.relief)
        if args.random_priors:
            write_random_priors(args.dst)
        print(args.dst)
    return 0


if __name__ == "__main__":
    sys.exit(main())
