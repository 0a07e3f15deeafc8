"""Multi-process execution across hosts — the port of
``acmmp_tpu/parallel/multihost.py`` and
``acmmp_tpu/parallel/sharding.py::maybe_init_distributed`` on
``torch.distributed``.

One process runs per host, or per card, under the variables ``torchrun``
sets (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``); ``maybe_init_distributed`` joins
them into one process group. Each process owns its share of its host's
cards (``owned_devices``), and one global mesh lists every process's
members in rank order (parallel/sharding.py::make_view_mesh). Every
process runs the same pipeline over its own members in lock-step with
the others, and the exchanges are host tensors over ``gloo``: each rank
moves its members' results to the host with ``.cpu()`` and every rank
receives all of them (``all_gather``), so every rank holds every view's
results and takes the same decisions. Device collectives (NCCL) are not
used: two processes on one card cannot share it under NCCL.

Host contract, the JAX package's: every process reads every view's
files (the dense folder lives on a shared filesystem); only rank 0
writes (``on_primary``), and ``barrier`` follows each stage whose files a
later stage reads. Without the variables every function here is the
single-process identity: no collective, no copy."""

from __future__ import annotations

import datetime
import math
import os
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
       "LOCAL_WORLD_SIZE")
# a rank that waits longer than this for the others fails, instead of
# hanging the run
TIMEOUT = datetime.timedelta(seconds=300)

# files this process wrote through on_primary (0 on every rank but 0)
files_written = 0


def maybe_init_distributed() -> bool:
    """Join the process group when the torchrun variables are set (gloo,
    ``tcp://MASTER_ADDR:MASTER_PORT``, TIMEOUT); a no-op without them, and
    when already joined. Raises when some are set and not all. Returns
    True when running multi-process."""
    if dist.is_available() and dist.is_initialized():
        return is_multiprocess()
    present = [v for v in ENV if v in os.environ]
    if not present:
        return False
    missing = [v for v in ENV if v not in os.environ]
    if missing:
        raise RuntimeError(f"multi-process run: {', '.join(present)} set "
                           f"but not {', '.join(missing)}")
    env = os.environ
    dist.init_process_group(
        "gloo", init_method=f"tcp://{env['MASTER_ADDR']}:"
                            f"{env['MASTER_PORT']}",
        rank=int(env["RANK"]), world_size=int(env["WORLD_SIZE"]),
        timeout=TIMEOUT)
    return is_multiprocess()


def is_multiprocess() -> bool:
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def rank() -> int:
    return dist.get_rank() if is_multiprocess() else 0


def world_size() -> int:
    return dist.get_world_size() if is_multiprocess() else 1


def is_primary() -> bool:
    """True on the process that writes the shared files."""
    return rank() == 0


def barrier(name: str) -> None:
    """Block until every process reaches this point (no-op when
    single-process): at stage boundaries where a later stage reads files
    that rank 0 wrote in this one. `name` says which, in the error."""
    if is_multiprocess():
        try:
            dist.barrier()
        except RuntimeError as e:
            raise RuntimeError(f"barrier {name!r}: {e}") from e


def on_primary(write, *args, **kwargs) -> None:
    """Run `write(*args, **kwargs)`, a file write, on rank 0 only, and
    count it: every process holds the same results, one writes them."""
    global files_written
    if is_primary():
        write(*args, **kwargs)
        files_written += 1


def owned_devices(local_rank: int, local_world_size: int,
                  n_visible: int) -> List[int]:
    """The card indices that process `local_rank` of `local_world_size`
    on a host of `n_visible` cards owns: a contiguous share when there
    are at least as many cards as processes, else card local_rank mod
    n_visible (several processes on one card)."""
    if n_visible < 1:
        raise ValueError("a process needs at least one visible card")
    if not 0 <= local_rank < local_world_size:
        raise ValueError(f"local rank {local_rank} of {local_world_size}")
    if local_world_size <= n_visible:
        return list(range(local_rank * n_visible // local_world_size,
                          (local_rank + 1) * n_visible // local_world_size))
    return [local_rank % n_visible]


def local_share(n_visible: int) -> List[int]:
    """This process's cards of the `n_visible` ones of its host: all of
    them when single-process."""
    if not is_multiprocess():
        return list(range(n_visible))
    return owned_devices(int(os.environ["LOCAL_RANK"]),
                         int(os.environ["LOCAL_WORLD_SIZE"]), n_visible)


def all_gather_object(obj) -> list:
    """Every rank's `obj` (picklable, small), in rank order."""
    if not is_multiprocess():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def all_gather(values: Dict[int, Sequence[torch.Tensor]]
               ) -> Dict[int, Tuple[torch.Tensor, ...]]:
    """The union of every rank's `values` (key -> tensors, the keys
    disjoint across ranks, each rank any number of them, of any shapes
    and dtypes), on every rank. This rank's own entries come back as
    given; the others' arrive as host tensors, bit for bit. One
    all_gather_object of the shapes, then one all_gather of the bytes
    (each rank's padded to the longest)."""
    values = {k: tuple(v) for k, v in values.items()}
    if not is_multiprocess():
        return values
    host = {k: [t.detach().cpu().contiguous() for t in v]
            for k, v in values.items()}
    meta = [(k, [(tuple(t.shape), t.dtype) for t in ts])
            for k, ts in host.items()]
    parts = [t.reshape(-1).view(torch.uint8) for ts in host.values()
             for t in ts]
    flat = (torch.cat(parts) if parts
            else torch.empty(0, dtype=torch.uint8))
    metas = all_gather_object((meta, flat.numel()))
    n = max(size for _, size in metas)
    out = dict(values)
    if n == 0:
        return out
    bufs = [torch.empty(n, dtype=torch.uint8) for _ in metas]
    padded = torch.zeros(n, dtype=torch.uint8)
    padded[:flat.numel()] = flat
    dist.all_gather(bufs, padded)
    for r, ((meta_r, _), buf) in enumerate(zip(metas, bufs)):
        if r == rank():
            continue
        off = 0
        for k, fields in meta_r:
            ts = []
            for shape, dtype in fields:
                nbytes = math.prod(shape) * torch.empty(
                    (), dtype=dtype).element_size()
                ts.append(buf[off:off + nbytes].clone().view(dtype)
                          .reshape(shape))
                off += nbytes
            out[k] = tuple(ts)
    return out
