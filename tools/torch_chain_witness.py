#!/usr/bin/env python3
"""The JAX package beside the port on the first two solves of the chain
(chip_smoke.py phase 7), on the CPU: a witness for the chain's depth error
that does not come from the port.

    JAX_PLATFORMS=cpu python3 tools/torch_chain_witness.py \
        [--width 800 --height 592 --f 1500] [--texture-scale 24] [--views 9]

Like the tests, and unlike the port, this script imports both packages.
On phase 7's coarse scene (textured_plane_scene, a plane at z = 5, view 0
the reference and the other views its sources) each package runs, with
the same key words (scheduler.py:347-348, 396-404), the photometric solve
of view 0 and then its planar-prior second solve, built by its own
build_planar_prior from its own first solve. The JAX package runs its
plain jnp ZNCC (no TPU here), the port its plain version. Prints, per
package and solve, the median interior |depth - z| and the interior share
under 0.5, the seconds the solve took, and the share of interior depths
within 1% and 5% of the other package's. At 800x592 each solve takes
minutes on a few CPU cores."""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=592)
    ap.add_argument("--f", type=float, default=1500.0)
    ap.add_argument("--texture-scale", type=float, default=24.0)
    ap.add_argument("--views", type=int, default=9)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    import jax

    from acmmp_tpu.config import PatchMatchParams as JaxParams
    from acmmp_tpu.engine import patchmatch as jpm
    from acmmp_tpu.engine.inputs import build_solver_inputs as jax_inputs
    from acmmp_tpu.engine.priors import build_planar_prior as jax_prior
    from acmmp_tpu.io.dense_folder import NumpyCamera as JaxCamera
    from acmmp_tpu_torch.config import PatchMatchParams, PipelineConfig
    from acmmp_tpu_torch.engine import patchmatch as tpm
    from acmmp_tpu_torch.engine.inputs import build_solver_inputs
    from acmmp_tpu_torch.engine.priors import build_planar_prior
    from acmmp_tpu_torch.ops import keys
    from acmmp_tpu_torch.utils.synth import textured_plane_scene

    w, h = args.width, args.height
    images, cams, plane_z = textured_plane_scene(
        n_views=args.views, width=w, height=h, f=args.f, plane_z=5.0,
        texture_scale=args.texture_scale)
    jcams = [JaxCamera(K=c.K, R=c.R, t=c.t, depth_min=c.depth_min,
                       depth_max=c.depth_max, width=c.width,
                       height=c.height) for c in cams]
    tp, jp = PatchMatchParams(), JaxParams(ncc_backend="jnp")
    dmin = float(cams[0].depth_min * tp.depth_min_relax)
    dmax = float(cams[0].depth_max * tp.depth_max_relax)
    seed = PipelineConfig().seed
    # view 0's first coarse solve, then its prior solve (fold_in 1)
    jkey = jax.random.fold_in(jax.random.key(seed), 0)
    tkey = keys.fold_in(keys.key(seed), 0)
    interior = np.s_[int(0.2 * h):int(0.8 * h), int(0.19 * w):int(0.81 * w)]
    print(f"{w}x{h}, f = {args.f}, texture scale {args.texture_scale}, "
          f"{args.views - 1} sources; CPU", flush=True)

    def report(pkg, name, depth, seconds):
        err = np.abs(depth[:h, :w][interior] - plane_z)
        print(f"  {pkg} {name}: median interior |depth - z| "
              f"{np.median(err):.5f}, share < 0.5 {(err < 0.5).mean():.4f}, "
              f"{seconds:.1f} s", flush=True)

    def jax_solve(mode, key, **maps):
        inp = jax_inputs(images[0], images[1:], jcams[0], jcams[1:], jp,
                         **maps)
        fn = jax.jit(functools.partial(jpm.run_patchmatch, params=jp,
                                       mode=mode))
        return jax.tree.map(np.asarray, fn(inp, key))

    def port_solve(mode, key, **maps):
        inp = build_solver_inputs(images[0], images[1:], cams[0], cams[1:],
                                  tp, device="cpu", **maps)
        out = tpm.run_patchmatch(inp, key, tp, mode)
        return tpm.SolverOutputs(*(t.numpy() for t in out))

    depths = {}
    for pkg, solve, prior, mode_cls, key, fold in (
            ("jax", jax_solve, jax_prior, jpm.Mode, jkey,
             jax.random.fold_in),
            ("port", port_solve, build_planar_prior, tpm.Mode, tkey,
             keys.fold_in)):
        t0 = time.perf_counter()
        out = solve(mode_cls(), key)
        report(pkg, "photometric", out.depth, time.perf_counter() - t0)
        planes, mask = prior(cams[0] if pkg == "port" else jcams[0],
                             out.depth[:h, :w], out.cost[:h, :w], dmin, dmax,
                             w, h)
        t0 = time.perf_counter()
        out2 = solve(mode_cls(planar_prior=True), fold(key, 1),
                     init_depth=out.depth[:h, :w],
                     init_normal_world=out.normal_world[:h, :w],
                     init_cost=out.cost[:h, :w], prior_planes=planes,
                     prior_mask=mask)
        report(pkg, "planar prior", out2.depth, time.perf_counter() - t0)
        depths[pkg] = (out.depth, out2.depth)
    for i, name in enumerate(("photometric", "planar prior")):
        a = depths["port"][i][:h, :w][interior]
        b = depths["jax"][i][:h, :w][interior]
        rel = np.abs(a - b) / np.abs(b)
        print(f"  port vs jax, {name}: interior depths within 1% "
              f"{(rel < 0.01).mean():.4f}, within 5% "
              f"{(rel < 0.05).mean():.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
