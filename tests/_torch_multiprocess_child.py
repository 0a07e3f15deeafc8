"""The inputs of tests/test_torch_multiprocess.py, and its child process.

    python tests/_torch_multiprocess_child.py OUT DENSE [cuda]

runs as one rank of a two-process run under the torchrun variables
(MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE): acmmp_tpu_torch.parallel.multihost joins the process
group, each rank gives two CPU members to one global mesh of four, and
the rank runs, in this order,

  5. run_pipeline(DENSE, CFG, mesh=...), counting its file writes;
  3. grouped fusion of those checkpoints over the mesh, and the
     sequential fuse_views of the same checkpoints, locally;
  1. the view-sharded solve of solve_batch();
  2. the bank all-gather: each rank fills only its own members' rows of
     bank_maps(), the others NaN;
  4. the tiled solve of tile_problem(), 24 rows a member;

and saves what it got to OUT/rank<RANK>.pt. With `cuda` it runs over
make_view_mesh(), its share of the host's cards, the pipeline and the
pipeline with every view tiled (TILED_CFG) alone.
Not collected by pytest (no test_ prefix); imports no JAX."""

import dataclasses
import os
import sys

import numpy as np
import torch

from acmmp_tpu_torch.config import (FusionParams, PatchMatchParams,
                                    PipelineConfig)
from acmmp_tpu_torch.engine.inputs import build_solver_inputs
from acmmp_tpu_torch.ops import keys
from acmmp_tpu_torch.parallel.sharding import stack_solver_inputs
from acmmp_tpu_torch.utils.synth import textured_plane_scene

N_VIEWS = 4
MEMBERS_PER_RANK = 2
PARAMS = PatchMatchParams(patch_size=7, max_iterations=1)
# one geometric pass, no planar prior; two iterations so that fusion
# keeps points of this scene (one keeps about one)
CFG = PipelineConfig(patchmatch=PatchMatchParams(patch_size=7,
                                                 max_iterations=2),
                     fusion=FusionParams(num_consistent_thresh=2),
                     pad_h=1, pad_w=1, geom_iterations=1,
                     planar_prior=False)
TILE_ROWS = 24        # a member's rows of the tiled view (the halo reach)
# every view above tile_pixels: rows over the members, halos between
# processes (96 rows: 24 a member of four)
TILED_CFG = dataclasses.replace(CFG, tile_pixels=1000, output_dir="TILED",
                                fusion_dir="TILED")


def _problems(n_views, width, height, params):
    images, cams, _ = textured_plane_scene(n_views=n_views, width=width,
                                           height=height)
    return [build_solver_inputs(
        images[i], [images[j] for j in range(n_views) if j != i], cams[i],
        [cams[j] for j in range(n_views) if j != i], params, device="cpu")
        for i in range(n_views)]


def solve_batch():
    """4 views at 64x48, each with the other three as sources, one key
    each."""
    batch = stack_solver_inputs(_problems(N_VIEWS, 64, 48, PARAMS))
    return batch, keys.stack([keys.fold_in(keys.key(0), i)
                              for i in range(N_VIEWS)])


def bank_maps():
    """An 8-map bank (two rows a member) and the [8, 3] source indices."""
    rng = np.random.default_rng(5)
    maps = torch.as_tensor(rng.uniform(1, 9, (8, 12, 16)).astype(np.float32))
    src_idx = torch.as_tensor(rng.integers(0, 8, (8, 3)))
    return maps, src_idx


def tile_problem():
    """One view at 64x96 (96 rows: 24 a member of four), its key."""
    return _problems(3, 64, 4 * TILE_ROWS, PARAMS)[0], keys.key(7)


def main(out, dense, cuda=False):
    from acmmp_tpu_torch.engine.fusion import fuse_views, load_fusion_views
    from acmmp_tpu_torch.engine.patchmatch import Mode
    from acmmp_tpu_torch.parallel import make_view_mesh, multihost, tiles
    from acmmp_tpu_torch.parallel.sharding import (
        gather_src_depths, member_rows, pad_to_multiple, view_sharded_solve)
    from acmmp_tpu_torch.pipeline import scheduler

    torch.set_num_threads(1)
    assert multihost.maybe_init_distributed()
    rank = multihost.rank()
    mesh = (make_view_mesh() if cuda
            else make_view_mesh(devices=["cpu"] * MEMBERS_PER_RANK))
    got = {"ranks": mesh.ranks, "local": mesh.local(),
           "devices": [str(d) for d in mesh]}

    # 5: the pipeline, rank 0 writing
    ply = scheduler.run_pipeline(dense, CFG, mesh=mesh)
    got["ply"] = ply
    got["files_written"] = multihost.files_written
    if cuda:
        scheduler.run_pipeline(dense, TILED_CFG, mesh=mesh)
    else:
        # 3: grouped fusion of the checkpoints, against the sequential one
        problems = scheduler.generate_sample_list(dense)
        out_folder = os.path.dirname(ply)

        def fuse(**kw):
            views = load_fusion_views(dense, out_folder, problems, True)
            return fuse_views(views, problems, CFG.fusion, **kw)
        got["fusion_mesh"] = fuse(mesh=mesh)
        got["fusion_seq"] = fuse(device="cpu")

        # 1: the view-sharded solve
        batch, kb = solve_batch()
        batch, kb, _ = pad_to_multiple(batch, kb, len(mesh))
        got["solve"] = [tuple(o) for o in view_sharded_solve(
            mesh, batch, kb, PARAMS, Mode())]

        # 2: the bank, each rank filling its own members' rows only
        maps, src_idx = bank_maps()
        mine = torch.full_like(maps, float("nan"))
        for m in mesh.local():
            rows = member_rows(len(maps), len(mesh), m)
            mine[rows] = maps[rows]
        got["bank"] = dict(zip(mesh.local(),
                               gather_src_depths(mesh, mine, src_idx)))

        # 4: the tiled solve
        inputs, key = tile_problem()
        got["tiled"] = tuple(tiles.tile_sharded_patchmatch(
            mesh, inputs, key, PARAMS, Mode()))
    multihost.barrier("saved")
    torch.save(got, os.path.join(out, f"rank{rank}.pt"))
    print(f"rank {rank}: done", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], cuda=sys.argv[3:] == ["cuda"])
