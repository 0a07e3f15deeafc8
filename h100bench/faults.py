"""Faults planted under the timed path, to show that a run's check
fails when the program's output is wrong. Each patches the program (the
PyTorch port) in this process and returns a function that undoes it.

* `unchanged`: every half-sweep returns its state unchanged.
* `half_batch`: a batch solves only its first half of views; the rest
  get the solved views' outputs.
* `altered`: the first view of each solve has its depth scaled by 1.02
  where the solve finalises it."""

from __future__ import annotations


def plant(name: str):
    import torch

    from acmmp_tpu_torch.engine import patchmatch as pm
    from acmmp_tpu_torch.pipeline import batched

    if name == "unchanged":
        orig = pm._sweep

        def sweep(state, *a, **kw):
            return state
        pm._sweep = sweep
        return lambda: setattr(pm, "_sweep", orig)
    if name == "half_batch":
        orig = batched.run_patchmatch_batch

        def half(inputs, keys_b, params, mode):
            from acmmp_tpu_torch.ops import keys

            B = inputs.ref_img.shape[0]
            h = max(1, B // 2)
            part = pm.SolverInputs(*(
                None if a is None
                else pm.geo.index_camera(a, slice(0, h))
                if isinstance(a, pm.geo.Camera) else a[:h]
                for a in inputs))
            out = orig(part, keys.KeyBatch(keys_b.words[:h]), params, mode)
            idx = torch.arange(B, device=inputs.ref_img.device) % h
            return pm.SolverOutputs(*(t[idx] for t in out))
        batched.run_patchmatch_batch = half
        return lambda: setattr(batched, "run_patchmatch_batch", orig)
    if name == "altered":
        orig = pm.finalize

        def finalize(state, inputs, params):
            out = orig(state, inputs, params)
            depth = out.depth.clone()
            depth[0] = depth[0] * 1.02
            return out._replace(depth=depth)
        pm.finalize = finalize
        return lambda: setattr(pm, "finalize", orig)
    raise ValueError(f"no fault {name!r}")
