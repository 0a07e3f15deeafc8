"""View-parallel execution over a device mesh — the port of
``acmmp_tpu/parallel/sharding.py``.

A mesh here is an ordered list of devices (``Mesh``), each member run by
one process (its rank, parallel/multihost.py); member m owns the
contiguous chunk that the JAX package's ``P("view")`` gives chip m:
rows [m n / P, (m + 1) n / P) of a batch of n = a multiple of P problems.
The parallel axes of the problem are those of the JAX module:

  * **view parallelism**: each reference view's solve is independent
    within a stage, so each member solves its chunk of a padded batch
    (``view_sharded_solve``);
  * **the geometric pass's bank**: every member needs the current depth
    maps of its problems' source views; each member holds its own views'
    maps, every member receives the whole bank (the all-gather) and picks
    each problem's sources with a local integer gather
    (``gather_src_depths``).

Each process advances its own members in lock-step from one host thread
(engine.patchmatch.run_patchmatch_members): each stage is issued for
every member before any host read, so the queues of several cards
overlap. The outputs and the bank cross processes through
``multihost.all_gather`` (host tensors), so every rank holds every
member's results; within one process they are the members' own tensors.
A single-process mesh is the same code with every member on rank 0. A
mesh may repeat a device: the CPU tests and chip_smoke.py run meshes
whose members all sit on one device. There is no fallback:
``make_view_mesh()`` without a CUDA device raises."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.core.geometry import Camera, stack_cameras
from acmmp_tpu_torch.engine.patchmatch import (Mode, SolverInputs,
                                               SolverOutputs,
                                               run_patchmatch_members)
from acmmp_tpu_torch.ops import keys
from acmmp_tpu_torch.parallel import multihost


class Mesh(tuple):
    """An ordered list of devices; members may repeat a device. The same
    list shards views (this module) or a view's image rows
    (parallel/tiles.py). `ranks[m]` is the process that runs member m
    (all 0 by default: a single-process mesh)."""

    def __new__(cls, devices, ranks=None):
        mesh = super().__new__(cls, (_device(d) for d in devices))
        if not mesh:
            raise ValueError("a mesh needs at least one device")
        mesh.ranks = (0,) * len(mesh) if ranks is None else tuple(ranks)
        if len(mesh.ranks) != len(mesh):
            raise ValueError(f"{len(mesh.ranks)} ranks for {len(mesh)} "
                             f"members")
        return mesh

    def local(self) -> List[int]:
        """The members this process runs, in mesh order."""
        me = multihost.rank()
        return [m for m, r in enumerate(self.ranks) if r == me]


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def cuda_devices(n_devices: Optional[int] = None) -> List[torch.device]:
    """This process's CUDA devices (the first `n_devices`): every visible
    one, or in a multi-process run its share of its host's
    (multihost.owned_devices); raises without one."""
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError(
            "acmmp_tpu_torch: a mesh of the visible CUDA devices was asked "
            "for, but there is none; pass devices=[...] for a mesh of "
            "given (possibly repeated) devices")
    devices = [torch.device("cuda", i) for i in
               multihost.local_share(torch.cuda.device_count())]
    return devices if n_devices is None else devices[:n_devices]


def make_view_mesh(n_devices: Optional[int] = None,
                   devices=None) -> Mesh:
    """A mesh over the view axis: this process's CUDA devices (the first
    `n_devices`), or the given `devices`, which may repeat one device. In
    a multi-process run (multihost.maybe_init_distributed) those are this
    process's members, and the mesh lists every process's members in
    rank order (one all_gather_object)."""
    mine = [str(_device(d)) for d in (cuda_devices(n_devices)
                                      if devices is None else devices)]
    per_rank = multihost.all_gather_object(mine)
    return Mesh([d for ds in per_rank for d in ds],
                [r for r, ds in enumerate(per_rank) for _ in ds])


def gather_members(mesh: Mesh, local: dict) -> list:
    """Every member's value on every rank, in mesh order: `local` maps
    this process's members to a tuple of tensors each (all of them, or
    those of a group), and every rank receives the others' as host
    tensors (multihost.all_gather); a member that no rank gave is None.
    Within one process the values come back as given."""
    if set(local) - set(mesh.local()):
        raise ValueError("gather_members: a value for a member this "
                         "process does not run")
    got = multihost.all_gather(local)
    return [got.get(m) for m in range(len(mesh))]


def map_tensors(t, fn):
    """`fn` applied to every tensor of a SolverInputs / SolverOutputs
    (camera fields included); None fields stay None."""
    def one(a):
        if a is None:
            return None
        if isinstance(a, Camera):
            return Camera(*(fn(f) for f in (a.K, a.R, a.t, a.width, a.height,
                                            a.depth_min, a.depth_max)))
        return fn(a)
    return type(t)(*(one(a) for a in t))


def check_placement(mesh: Mesh, members: Sequence[SolverInputs]) -> None:
    """Raise unless every tensor of this process's members' inputs
    (`members`, in the order of mesh.local()) sits on its member's
    device."""
    local = mesh.local()
    if len(members) != len(local):
        raise ValueError(f"{len(members)} member inputs for this "
                         f"process's {len(local)} members")
    for m, mi in zip(local, members):
        dev = mesh[m]
        def on(t):
            if t.device != dev:
                raise ValueError(f"member {m} of the mesh has an input on "
                                 f"{t.device}, not on its device {dev}")
            return t
        map_tensors(mi, on)


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


def pad_to_multiple(batch: SolverInputs, keys_b: keys.KeyBatch, m: int):
    """Pad the leading view axis to a multiple of `m` (the mesh size) by
    repeating the last problem; returns (batch, keys, valid [Np] bool)."""
    n = len(keys_b)
    pad = -n % m
    valid = torch.arange(n + pad, device=batch.ref_img.device) < n
    if pad == 0:
        return batch, keys_b, valid
    batch = map_tensors(batch, lambda x: torch.cat(
        [x, x[-1:].expand((pad,) + x.shape[1:])]))
    words = keys_b.words
    return batch, keys.KeyBatch([*words, *([words[-1]] * pad)]), valid


def member_rows(n: int, size: int, m: int) -> slice:
    """The rows of an [n, ...] axis that member m of a mesh of `size`
    owns (n a multiple of size)."""
    if n % size:
        raise ValueError(f"{n} rows do not split over {size} members")
    per = n // size
    return slice(m * per, (m + 1) * per)


def shard_batch(mesh: Mesh, batch):
    """This process's members' chunks of a batch (SolverInputs or a
    tensor with a leading view axis), each on its member's device, in
    the order of mesh.local(): the leading-axis view sharding."""
    def chunk(m):
        rows = member_rows(_leading(batch), len(mesh), m)
        to = lambda x: x[rows].to(mesh[m])                    # noqa: E731
        return to(batch) if torch.is_tensor(batch) else map_tensors(batch,
                                                                    to)
    return [chunk(m) for m in mesh.local()]


def _leading(batch) -> int:
    return (batch.shape[0] if torch.is_tensor(batch)
            else batch.ref_img.shape[0])


def _shard_keys(mesh: Mesh, keys_b: keys.KeyBatch) -> List[keys.KeyBatch]:
    return [keys.KeyBatch(keys_b.words[member_rows(len(keys_b), len(mesh),
                                                   m)])
            for m in mesh.local()]


def _solve_members(mesh: Mesh, members: Sequence[SolverInputs],
                   keys_b: keys.KeyBatch, params: PatchMatchParams,
                   mode: Mode) -> List[SolverOutputs]:
    """This process's members solved in lock-step, then every member's
    outputs gathered to every rank (mesh order)."""
    check_placement(mesh, members)
    outs = run_patchmatch_members(members, _shard_keys(mesh, keys_b),
                                  params, mode)
    got = gather_members(mesh, dict(zip(mesh.local(), outs)))
    return [SolverOutputs(*o) for o in got]


def view_sharded_solve(mesh: Mesh, batch: SolverInputs,
                       keys_b: keys.KeyBatch, params: PatchMatchParams,
                       mode: Mode) -> List[SolverOutputs]:
    """A photometric (or hierarchy, seeded, planar-prior) pass for a batch
    of reference views, sharded over the mesh: each member solves its
    chunk as one batch, each process's members in lock-step. `batch`'s
    leading axis must be a multiple of the mesh size (pad_to_multiple).
    Returns every member's shard on every rank: this process's on their
    members' devices, the others' on the host."""
    if batch.ref_img.ndim != 3:
        raise ValueError("view_sharded_solve: the batch needs a leading "
                         "view axis")
    return _solve_members(mesh, shard_batch(mesh, batch), keys_b, params,
                          mode)


def gather_bank(mesh: Mesh, depth_maps) -> List[torch.Tensor]:
    """Every member's shard of the [N, Hs, Ws] bank, in mesh order, on
    every rank: `depth_maps` is the member shards in mesh order (those of
    other processes' members are not read and may be None) or the whole
    bank, of which member m holds chunk m. Each process gives its own
    members' shards; the all-gather brings the others'."""
    if torch.is_tensor(depth_maps):
        depth_maps = [depth_maps[member_rows(len(depth_maps), len(mesh), m)]
                      for m in range(len(mesh))]
    if len(depth_maps) != len(mesh):
        raise ValueError(f"{len(depth_maps)} bank shards for a mesh of "
                         f"{len(mesh)}")
    got = gather_members(mesh, {m: (depth_maps[m],) for m in mesh.local()})
    return [g[0] for g in got]


def gather_src_depths(mesh: Mesh, depth_maps, src_idx: torch.Tensor
                      ) -> List[torch.Tensor]:
    """The geometric pass's stage-barrier collective: every member holds
    its own views' current depth maps (`depth_maps`, as gather_bank takes
    them); every member receives the whole bank (gather_bank: copies to
    its device, none on a repeated device), then a local integer gather
    picks each of its problems' source maps (`src_idx` [B, V] indices
    into the bank, chunk m member m's). Returns this process's members'
    shards of the [B, V, Hs, Ws] result, in the order of mesh.local().
    Both leading dims must be multiples of the mesh size."""
    bank = gather_bank(mesh, depth_maps)
    idx = shard_batch(mesh, torch.as_tensor(src_idx, dtype=torch.int64))
    out = []
    for m, si in zip(mesh.local(), idx):
        full = torch.cat([d.to(mesh[m]) for d in bank])
        out.append(full[si])
    return out


def view_sharded_geometric_solve(mesh: Mesh, batch: SolverInputs,
                                 depth_maps, src_idx: torch.Tensor,
                                 keys_b: keys.KeyBatch,
                                 params: PatchMatchParams,
                                 mode: Mode) -> List[SolverOutputs]:
    """A geometric-consistency pass: gathers the current depth maps over
    the mesh (gather_src_depths), gives each problem its source maps,
    then runs the sharded solve. `batch` comes without src_depths; its
    leading axis, `src_idx`'s and the bank's are multiples of the mesh
    size. Returns every member's shard on every rank, as
    view_sharded_solve."""
    if not mode.geom_consistency:
        raise ValueError("view_sharded_geometric_solve needs a geometric "
                         "mode")
    if batch.src_depths is not None:
        raise ValueError("view_sharded_geometric_solve builds src_depths "
                         "from depth_maps; the batch must not carry them")
    gathered = gather_src_depths(mesh, depth_maps, src_idx)
    members = [b._replace(src_depths=g)
               for b, g in zip(shard_batch(mesh, batch), gathered)]
    return _solve_members(mesh, members, keys_b, params, mode)
