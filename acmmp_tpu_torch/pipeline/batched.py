"""Batched (and optionally mesh-sharded) execution of per-view solves —
the port of ``acmmp_tpu/pipeline/batched.py`` within one process.

The reference loops reference views one at a time on one GPU
(src/main_ACMMP.cpp:112-137). Here a batch of B views of one static shape
runs as one solve: a leading batch axis goes through every solver tensor
op and a batch index through each kernel's grid (csrc/zncc.cu,
csrc/geom.cu), so the batch issues the launches of one solve (13 ZNCC
launches, and 9 geom launches in a geometric mode) and each launch does
B views' work. The JAX executor maps its stages over the batch view
after view (``lax.map``: its Pallas kernel has no batching rule); the
semantics are the same: each view gets its own key schedule and its own
results, those of its single-view solve.

With a mesh (parallel/sharding.py) the batch is padded to a multiple of
the global mesh size by repeating its last problem (pad_to_multiple),
and member m solves the m-th chunk of the padded batch on its device,
each process's members in lock-step (parallel.sharding.
view_sharded_solve); every rank receives every member's results, and
the padding's are dropped. A geometric pass on a mesh takes its
source depth maps from the pass's bank: each member gathers its own
problems' maps onto its device
(parallel.sharding.view_sharded_geometric_solve)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.engine.patchmatch import (Mode, SolverInputs,
                                               SolverOutputs,
                                               run_patchmatch_batch, view_of)
from acmmp_tpu_torch.ops import keys
from acmmp_tpu_torch.parallel.sharding import (
    Mesh, pad_to_multiple, stack_solver_inputs, view_sharded_geometric_solve,
    view_sharded_solve)


class BatchedSolver:
    """Solves batches of same-shape problems on their device, or sharded
    over `mesh`. One instance per pipeline run."""

    def __init__(self, params: PatchMatchParams,
                 mesh: Optional[Mesh] = None):
        self.params = params
        self.mesh = mesh

    def padded_size(self, n: int) -> int:
        """Batch size after padding to a mesh multiple."""
        if self.mesh is None:
            return n
        return -(-n // len(self.mesh)) * len(self.mesh)

    def solve_batch(self, inputs_list: Sequence[SolverInputs],
                    keys_list: Sequence[keys.Key], mode: Mode,
                    depth_bank: Optional[Tuple[List[torch.Tensor],
                                               torch.Tensor]] = None
                    ) -> List[SolverOutputs]:
        """Solve a batch of same-shape problems, one key each; returns
        per-view outputs (views of the batch's tensors, padding replicas
        dropped; on a mesh this process's members' on their devices, the
        other processes' on the host). The per-view
        stage keys are derived as the JAX executor derives them (split,
        then fold_in per sweep: engine.patchmatch.run_patchmatch_batch),
        so a seed gives the same reconstruction in every executor
        configuration.

        `depth_bank` (a geometric pass on a mesh) is (the bank's member
        shards, src_idx [n, V] rows of the bank): the problems come
        without src_depths, and each member gathers its problems' source
        maps onto its own device."""
        if len(inputs_list) != len(keys_list):
            raise ValueError(f"{len(inputs_list)} problems and "
                             f"{len(keys_list)} keys")
        n = len(inputs_list)
        batch = stack_solver_inputs(inputs_list)
        kb = keys.stack(keys_list)
        if self.mesh is None:
            if depth_bank is not None:
                raise ValueError("a depth bank is gathered over a mesh; "
                                 "this solver has none")
            out = run_patchmatch_batch(batch, kb, self.params, mode)
            return [view_of(out, b) for b in range(n)]
        batch, kb, _ = pad_to_multiple(batch, kb, len(self.mesh))
        n_pad = self.padded_size(n)
        if depth_bank is None:
            shards = view_sharded_solve(self.mesh, batch, kb, self.params,
                                        mode)
        else:
            bank, src_idx = depth_bank
            src_idx = torch.as_tensor(src_idx, dtype=torch.int64)
            src_idx = torch.cat([src_idx, src_idx[-1:].expand(
                n_pad - n, -1)])
            shards = view_sharded_geometric_solve(
                self.mesh, batch, bank, src_idx, kb, self.params, mode)
        per = n_pad // len(self.mesh)     # each member's problems
        return [view_of(shards[j // per], j % per) for j in range(n)]
