"""Batched execution of per-view solves — the port of
``acmmp_tpu/pipeline/batched.py`` without its mesh.

The reference loops reference views one at a time on one GPU
(src/main_ACMMP.cpp:112-137). Here a batch of B views of one static shape
runs as one solve: a leading batch axis goes through every solver tensor
op and a batch index through each kernel's grid (csrc/zncc.cu,
csrc/geom.cu), so the batch issues the launches of one solve (13 ZNCC
launches, and 9 geom launches in a geometric mode) and each launch does
B views' work. The JAX executor maps its stages over the batch view
after view (``lax.map``: its Pallas kernel has no batching rule); the
semantics are the same: each view gets its own key schedule and its own
results, those of its single-view solve. The mesh (``--mesh``) is the
multi-GPU executor's, not ported yet (ROADMAP Queue 1 item 6)."""

from __future__ import annotations

from typing import List, Sequence

from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.engine.patchmatch import (Mode, SolverInputs,
                                               SolverOutputs,
                                               run_patchmatch_batch, view_of)
from acmmp_tpu_torch.ops import keys
from acmmp_tpu_torch.parallel.sharding import stack_solver_inputs


class BatchedSolver:
    """Solves batches of same-shape problems on their device. One
    instance per pipeline run."""

    def __init__(self, params: PatchMatchParams):
        self.params = params

    def solve_batch(self, inputs_list: Sequence[SolverInputs],
                    keys_list: Sequence[keys.Key],
                    mode: Mode) -> List[SolverOutputs]:
        """Solve a batch of same-shape problems, one key each; returns
        per-view outputs (views of the batch's tensors). The per-view
        stage keys are derived as the JAX executor derives them (split,
        then fold_in per sweep: engine.patchmatch.run_patchmatch_batch),
        so a seed gives the same reconstruction in every executor
        configuration."""
        if len(inputs_list) != len(keys_list):
            raise ValueError(f"{len(inputs_list)} problems and "
                             f"{len(keys_list)} keys")
        out = run_patchmatch_batch(stack_solver_inputs(inputs_list),
                                   keys.stack(keys_list), self.params, mode)
        return [view_of(out, b) for b in range(len(inputs_list))]
