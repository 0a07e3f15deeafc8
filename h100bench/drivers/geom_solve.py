"""Driver of solve cells: the geometric-consistency pass of a scene's
views through the program's batched executor
(`pipeline.batched.BatchedSolver.solve_batch`), `view_batch` views a
unit, cycling the views with fresh keys.

Set-up renders the configuration's scene from the seed, makes the
previous pass's maps from its truth (`scene.relief.previous_pass`) and
stages every view's inputs on the device through the program's
`engine.inputs.build_solver_inputs`: its image and sources, its own
maps as the re-entry state, its sources' maps as the depth bank. The
check solves every view of one unit with the plain reference on the
same host arrays and keys. That unit is drawn from the seed before the
window, among the mix's first `check_among` units, which every run
completes. Its outputs stay on the device until the window has closed
(no copy inside the window or a traced stretch), and every other unit's
outputs are dropped as its step returns."""

from __future__ import annotations

import time

import numpy as np
import torch

from h100bench import tally
from h100bench.reference import compare
from h100bench.reference import keys as rkeys
from h100bench.scene import relief


def unit_key(seed: int, unit: int, view: int):
    """The key words of `view` in window unit `unit` (warm-up: -1)."""
    k = rkeys.fold_in(rkeys.key(seed), unit & 0xFFFFFFFF)
    return rkeys.fold_in(k, view)


class Driver:
    counted = "maps"

    def __init__(self, cfg: dict, mix: dict, seed: int, device, spans):
        from acmmp_tpu_torch.config import PatchMatchParams
        from acmmp_tpu_torch.engine.inputs import build_solver_inputs
        from acmmp_tpu_torch.engine.patchmatch import Mode
        from acmmp_tpu_torch.io.dense_folder import NumpyCamera
        from acmmp_tpu_torch.ops import keys as pkeys
        from acmmp_tpu_torch.pipeline.batched import BatchedSolver

        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.device = torch.device(device)
        sc = cfg["scene"]
        scene = relief.make_scene(sc, self.seed, self.device)
        depth, normal = relief.previous_pass(scene, mix["previous_pass"],
                                             self.seed)
        # the host arrays both sides stage from
        self.images = scene.images.cpu().numpy()
        self.depth = depth.cpu().numpy()
        self.normal = normal.cpu().numpy()
        self.views, self.pairs = scene.views, scene.pairs
        del scene, depth, normal
        H, W = sc["image_height"], sc["image_width"]
        self.H, self.W, self.V = H, W, sc["sources_per_view"]
        self.pm = dict(cfg["patchmatch"])
        self.params = PatchMatchParams(**self.pm)
        self.mode = Mode(geom_consistency=True)
        self.pkey = lambda w: pkeys.Key(int(w.k0), int(w.k1))
        cams = [NumpyCamera(v.K, v.R, v.t, v.depth_min, v.depth_max, W, H)
                for v in self.views]
        pipe = cfg["pipeline"]
        self.inputs = [
            build_solver_inputs(
                self.images[i], [self.images[s] for s in self.pairs[i]],
                cams[i], [cams[s] for s in self.pairs[i]], self.params,
                num_views_pad=self.V, pad_h=pipe["pad_h"],
                pad_w=pipe["pad_w"],
                src_depths=[self.depth[s] for s in self.pairs[i]],
                init_depth=self.depth[i], init_normal_world=self.normal[i],
                device=self.device)
            for i in range(len(self.views))]
        self.solver = BatchedSolver(self.params)
        self.batch = mix["view_batch"]
        self.next_view = 0
        self.unit = 0
        self.pick = int(np.random.default_rng(self.seed).integers(
            mix["check_among"]))
        self.kept = self.sample = None
        t = tally.solve(H, W, self.V, self.pm, geometric=True)
        self.unit_tally = {k: v * self.batch for k, v in t.items()}

    def _solve(self, unit: int, ids):
        ks = [unit_key(self.seed, unit, i) for i in ids]
        outs = self.solver.solve_batch([self.inputs[i] for i in ids],
                                       [self.pkey(k) for k in ks],
                                       self.mode)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return ks, outs

    def warmup(self) -> None:
        self._solve(-1, list(range(self.batch)))

    def step(self):
        n = len(self.views)
        ids = [(self.next_view + j) % n for j in range(self.batch)]
        self.next_view = (self.next_view + self.batch) % n
        ks, outs = self._solve(self.unit, ids)
        if self.unit == self.pick:
            self.kept = (ids, ks, outs)
        del outs
        self.unit += 1
        return [time.perf_counter()] * len(ids)

    def tally(self, steps: int) -> dict:
        """The work of `steps` units: {kernel: [(operations, bytes)]}."""
        return {k: v * steps for k, v in self.unit_tally.items()}

    def release(self) -> None:
        """Copy the drawn unit's outputs to the host for the check; free
        the program's device state."""
        if self.kept is not None:
            ids, ks, outs = self.kept
            H, W = self.H, self.W
            self.sample = (ids, ks, [
                (o.depth[:H, :W].cpu().numpy(),
                 o.normal_world[:H, :W].cpu().numpy(),
                 o.cost[:H, :W].cpu().numpy()) for o in outs])
        self.kept = self.inputs = self.solver = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, ids, ks, zncc_dtype="float32"):
        """The plain reference's maps (true extent, host) of views `ids`
        with key words `ks`."""
        from h100bench.reference import inputs as rin
        from h100bench.reference import params as rpar
        from h100bench.reference import solver as rsol

        rp = rpar.PatchMatchParams(**{**self.pm, "ncc_backend": "plain",
                                      "zncc_dtype": zncc_dtype})
        W, H = self.W, self.H
        cams = [rin.NumpyCamera(v.K, v.R, v.t, v.depth_min, v.depth_max,
                                W, H) for v in self.views]
        pipe = self.cfg["pipeline"]
        out = []
        for i, k in zip(ids, ks):
            inp = rin.build_solver_inputs(
                self.images[i], [self.images[s] for s in self.pairs[i]],
                cams[i], [cams[s] for s in self.pairs[i]], rp,
                num_views_pad=self.V, pad_h=pipe["pad_h"],
                pad_w=pipe["pad_w"],
                src_depths=[self.depth[s] for s in self.pairs[i]],
                init_depth=self.depth[i], init_normal_world=self.normal[i],
                device=self.device)
            o = rsol.run_patchmatch(inp, k, rp,
                                    rsol.Mode(geom_consistency=True))
            out.append((o.depth[:H, :W].cpu().numpy(),
                        o.normal_world[:H, :W].cpu().numpy(),
                        o.cost[:H, :W].cpu().numpy()))
            del inp, o
        return out

    def check(self):
        """(numbers compared, numbers printed beside them) of the drawn
        unit against the reference, whose maps stay in `ref_maps`; every
        number infinite when the window never reached that unit."""
        if self.sample is None:
            w = {k: float("inf") for k in compare.NUMBERS}
            return w, {"unit": self.pick, "reached": self.unit}
        ids, ks, got = self.sample
        t0 = time.perf_counter()
        self.ref_maps = self.reference(ids, ks)
        w = compare.worst([compare.solve_gaps(*g, *r)
                           for g, r in zip(got, self.ref_maps)])
        info = {"unit": self.pick, "views": ids,
                "reference_s": time.perf_counter() - t0,
                **{f"all.{k}": v for k, v in w.items()}}
        return w, info

    def control(self):
        """The control's numbers: the reference with its ZNCC moments in
        bfloat16, in the program's place, against the reference."""
        ids, ks, _ = self.sample
        ctl = self.reference(ids, ks, zncc_dtype="bfloat16")
        return compare.worst([compare.solve_gaps(*c, *r)
                              for c, r in zip(ctl, self.ref_maps)])
