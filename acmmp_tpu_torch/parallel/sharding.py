"""Stacking per-view solver inputs into a batch — the port of
``acmmp_tpu/parallel/sharding.py::stack_solver_inputs``.

The batched executor (pipeline/batched.py) solves B reference views of
one static shape per launch stream; this gives it their inputs with a
leading [B] on every field. The mesh specs and ``pad_to_multiple`` of the
JAX module belong to the multi-GPU executor and are not ported yet
(ROADMAP Queue 1 item 6)."""

from __future__ import annotations

from typing import Sequence

import torch

from acmmp_tpu_torch.core.geometry import Camera, stack_cameras
from acmmp_tpu_torch.engine.patchmatch import SolverInputs


def stack_solver_inputs(inputs: Sequence[SolverInputs]) -> SolverInputs:
    """Stack per-view SolverInputs (identical static shapes, the same
    optional fields) into one batched SolverInputs with a leading view
    axis [N, ...]; cameras stack field by field (geometry.stack_cameras:
    [N] reference cameras, [N, V] source cameras)."""
    if not inputs:
        raise ValueError("stack_solver_inputs: no inputs")

    def stack(*xs):
        if xs[0] is None:
            if any(x is not None for x in xs):
                raise ValueError("stack_solver_inputs: an optional field is "
                                 "given for some views and not others")
            return None
        if isinstance(xs[0], Camera):
            return stack_cameras(xs)
        shapes = {tuple(x.shape) for x in xs}
        if len(shapes) != 1:
            raise ValueError(f"stack_solver_inputs: shapes differ: "
                             f"{sorted(shapes)}")
        return torch.stack(xs)

    return SolverInputs(*(stack(*xs) for xs in zip(*inputs)))
