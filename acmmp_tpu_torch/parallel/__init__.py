from acmmp_tpu_torch.parallel.sharding import (
    make_view_mesh,
    pad_to_multiple,
    stack_solver_inputs,
    view_sharded_geometric_solve,
    view_sharded_solve,
)

__all__ = [
    "make_view_mesh",
    "pad_to_multiple",
    "stack_solver_inputs",
    "view_sharded_solve",
    "view_sharded_geometric_solve",
]
