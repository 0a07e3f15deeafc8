#!/usr/bin/env python3
"""The JAX package beside the port on the plain variant of the DTU method
grid (chip_smoke.py phase 10), on the CPU: a witness for how many points
fusion keeps on that scene that does not come from the port.

    JAX_PLATFORMS=cpu python3 tools/torch_grid_witness.py \
        [--width 320 --height 240 --views 49 --cams 3]

Like the tests, and unlike the port, this script imports both packages.
It builds phase 10's scan (textured_relief_scene, f = 140 W / 96, spread
1.2, convergent rig), selects the camera subset DTU_CAM_SETS[cams] with
analyze_dtu_scans' ReconParams into one folder per package, and runs each
package's run_pipeline with its default PipelineConfig there: the JAX
package with its plain jnp kernels (no TPU here), the port on the CPU.
Prints, per package, the fused points, their share of one view's pixels
and the seconds the pipeline took. At 320x240 the JAX pipeline takes
minutes on a few CPU cores, most of it compiling."""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--views", type=int, default=49)
    ap.add_argument("--cams", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    from acmmp_tpu.config import PipelineConfig as JaxConfig
    from acmmp_tpu.io import read_ply as jax_read_ply
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
    w, h = args.width, args.height
    images, cams, _ = textured_relief_scene(
        n_views=args.views, width=w, height=h, f=140.0 * w / 96.0,
        spread=1.2, converge=True)
    subset = DTU_CAM_SETS[args.cams]
    print(f"{w}x{h}, {args.views}-view relief scan, cameras {subset}; CPU",
          flush=True)
    with tempfile.TemporaryDirectory() as work:
        scan = write_dense_folder(os.path.join(work, "relief"), images, cams)
        # analyze_dtu_scans' selection parameters
        params = ReconParams(mindist=300, maxdist=800, maxangle=120)
        runs = (("jax", lambda d: jax_pipeline(d, JaxConfig()),
                 jax_read_ply),
                ("port", lambda d: run_pipeline(d, PipelineConfig(),
                                                device="cpu"), read_ply))
        for name, run, reader in runs:
            dense = os.path.join(work, name)
            setup_from_source(subset, scan, dense, params)
            t0 = time.perf_counter()
            ply = run(dense)
            seconds = time.perf_counter() - t0
            n = len(reader(ply)[0])
            print(f"{name}: {n} fused points, {n / (w * h):.4f} of a view, "
                  f"pipeline {seconds:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
