"""acmmp_tpu_torch across processes (parallel/multihost.py): two real
torch.distributed processes (gloo, a localhost address), each with two
CPU members, make one global mesh of four. The children
(tests/_torch_multiprocess_child.py) run the view-sharded solve, the
bank all-gather, grouped fusion, the tiled solve and run_pipeline over
it, and every result must equal, torch.equal or byte-equal, what a
single-process mesh of four members gives; rank 1 writes no file. The
JAX package's run_fusion of the two-process checkpoints writes their PLY
bytes. Plus the card-ownership rule and maybe_init_distributed's
variables, and, on a host with four cards, two processes of two cards
each against the single-process mesh of the four.

The children run under communicate(timeout=300), killed on timeout, and
their process group has its own 300 s timeout."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from acmmp_tpu_torch.engine.patchmatch import Mode, run_patchmatch
from acmmp_tpu_torch.io import read_ply
from acmmp_tpu_torch.parallel import make_view_mesh, multihost
from acmmp_tpu_torch.parallel.sharding import (member_rows, pad_to_multiple,
                                               view_sharded_solve)
from acmmp_tpu_torch.pipeline import scheduler
from acmmp_tpu_torch.utils.synth import (textured_plane_scene,
                                         write_dense_folder)

from . import _torch_multiprocess_child as child

try:
    from acmmp_tpu.config import FusionParams as JaxFusionParams
    from acmmp_tpu.engine.fusion import run_fusion as jax_run_fusion
    from acmmp_tpu.pipeline import scheduler as jsched
except ImportError:      # a card machine without JAX: the card test only
    jax_run_fusion = None

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_torch_multiprocess_child.py")
TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(out, dense, *extra):
    """The two ranks, started together; (process, its output file)."""
    port = str(_free_port())
    procs = []
    for r in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE="2",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        log = open(os.path.join(out, f"rank{r}.log"), "w+")
        procs.append((subprocess.Popen(
            [sys.executable, CHILD, out, dense, *extra], env=env, cwd=REPO,
            stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _finish(procs):
    """Wait for both ranks (TIMEOUT_S each), kill both on a timeout or a
    failure, and fail with the ranks' output unless both exit 0."""
    try:
        for p, _ in procs:
            p.communicate(timeout=TIMEOUT_S)
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for p, log in procs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    for r, ((p, _), text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            pytest.fail(f"rank {r} exited {p.returncode}:\n{text[-6000:]}")


def _tree(root):
    """Relative path -> bytes of every file under `root`."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two-process run and, computed while it runs, the same work on
    a single-process mesh of four CPU members."""
    root = str(tmp_path_factory.mktemp("mp"))
    images, cams, plane_z = textured_plane_scene(n_views=child.N_VIEWS,
                                                 width=64, height=48)
    dense = {k: write_dense_folder(os.path.join(root, k), images, cams)
             for k in ("two", "one")}
    procs = _start(root, dense["two"])
    try:
        mesh = make_view_mesh(devices=["cpu"] * 4)
        before = multihost.files_written
        ref = {"ply": scheduler.run_pipeline(dense["one"], child.CFG,
                                             mesh=mesh)}
        ref["files_written"] = multihost.files_written - before
        batch, kb = child.solve_batch()
        batch, kb, _ = pad_to_multiple(batch, kb, len(mesh))
        ref["solve"] = [tuple(o) for o in view_sharded_solve(
            mesh, batch, kb, child.PARAMS, Mode())]
        inputs, key = child.tile_problem()
        ref["untiled"] = tuple(run_patchmatch(inputs, key, child.PARAMS,
                                              Mode()))
    finally:
        _finish(procs)
    got = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
           for r in range(2)]
    return {"dense": dense, "plane_z": plane_z, "ref": ref, "got": got}


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_global_mesh_lists_every_rank(runs):
    for r, g in enumerate(runs["got"]):
        assert g["ranks"] == (0, 0, 1, 1)
        assert g["local"] == [2 * r, 2 * r + 1]
        assert g["devices"] == ["cpu"] * 4


def test_view_sharded_solve_across_processes(runs):
    ref = runs["ref"]["solve"]
    for g in runs["got"]:
        assert len(g["solve"]) == 4
        for m, (a, b) in enumerate(zip(g["solve"], ref)):
            assert _equal(a, b), m


def test_bank_all_gather_across_processes(runs):
    maps, src_idx = child.bank_maps()
    for r, g in enumerate(runs["got"]):
        assert sorted(g["bank"]) == [2 * r, 2 * r + 1]
        for m, out in g["bank"].items():
            want = maps[src_idx[member_rows(len(src_idx), 4, m)]]
            assert torch.equal(out, want), (r, m)


def test_grouped_fusion_across_processes(runs):
    for g in runs["got"]:
        seq, mesh = g["fusion_seq"], g["fusion_mesh"]
        assert len(seq[0]) > 0
        for a, b in zip(mesh, seq):
            np.testing.assert_array_equal(a, b)


def test_tiled_solve_across_processes(runs):
    for g in runs["got"]:
        assert _equal(g["tiled"], runs["ref"]["untiled"])


def test_pipeline_across_processes(runs):
    """The .dmb files, pass markers and PLY bytes of the two-process run
    equal the single-process mesh's; rank 0 made the single-process
    run's writes (each file once, normals and costs again in the
    geometric pass) and rank 1 none."""
    two, one = (_tree(os.path.join(runs["dense"][k], "ACMMP"))
                for k in ("two", "one"))
    assert sorted(two) == sorted(one)
    assert sum(k.endswith(".dmb") for k in two) == 4 * child.N_VIEWS
    assert sum(".pass_" in k for k in two) == 2 * child.N_VIEWS
    assert "ACMMP_model.ply" in two
    for k in one:
        assert two[k] == one[k], k
    r0, r1 = runs["got"]
    assert r1["files_written"] == 0
    assert r0["files_written"] == runs["ref"]["files_written"] == len(two) + 8
    pts = read_ply(r0["ply"])[0]
    assert len(pts) > 0
    assert np.median(np.abs(pts[:, 2] - runs["plane_z"])) < 0.1


def test_jax_fusion_of_two_process_checkpoints(runs, tmp_path):
    """The JAX package's run_fusion of the two-process run's checkpoints
    writes that run's PLY bytes."""
    if jax_run_fusion is None:
        pytest.skip("needs JAX")
    dense = runs["dense"]["two"]
    out = os.path.join(dense, "ACMMP")
    fp = child.CFG.fusion
    jply = jax_run_fusion(
        dense, out, jsched.generate_sample_list(dense),
        geom_consistency=True,
        fp=JaxFusionParams(num_consistent_thresh=fp.num_consistent_thresh),
        ply_name="jax.ply")
    with open(jply, "rb") as a, open(runs["got"][0]["ply"], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("local_rank, local_world, n_visible, want", [
    (0, 1, 1, [0]), (0, 1, 4, [0, 1, 2, 3]), (0, 2, 4, [0, 1]),
    (1, 2, 4, [2, 3]), (1, 3, 8, [2, 3, 4]), (2, 3, 8, [5, 6, 7]),
    (0, 2, 1, [0]), (1, 2, 1, [0]), (3, 4, 2, [1]), (2, 3, 2, [0])])
def test_owned_devices(local_rank, local_world, n_visible, want):
    assert multihost.owned_devices(local_rank, local_world,
                                   n_visible) == want


def test_owned_devices_rejects_bad_ranks():
    with pytest.raises(ValueError):
        multihost.owned_devices(2, 2, 4)
    with pytest.raises(ValueError):
        multihost.owned_devices(0, 1, 0)


def test_maybe_init_distributed_without_variables(monkeypatch):
    for v in multihost.ENV:
        monkeypatch.delenv(v, raising=False)
    assert multihost.maybe_init_distributed() is False
    assert not torch.distributed.is_initialized()
    assert not multihost.is_multiprocess() and multihost.is_primary()
    assert multihost.all_gather_object(3) == [3]
    t = torch.arange(3)
    assert multihost.all_gather({5: (t,)})[5][0] is t


def test_maybe_init_distributed_partial_variables_raise(monkeypatch):
    for v in multihost.ENV:
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        multihost.maybe_init_distributed()
    assert not torch.distributed.is_initialized()


@pytest.mark.cuda
def test_two_processes_on_four_cards(tmp_path):
    """On a host with four cards: two processes of two cards each write
    the .dmb files, markers and PLY bytes of the single-process mesh of
    the four cards, view-sharded and with every view tiled (halos
    between the processes' cards)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    images, cams, _ = textured_plane_scene(n_views=child.N_VIEWS, width=128,
                                           height=96)
    dense = {k: write_dense_folder(str(tmp_path / k), images, cams)
             for k in ("two", "one")}
    procs = _start(str(tmp_path), dense["two"], "cuda")
    try:
        ref_mesh = make_view_mesh()
        assert len(ref_mesh) == 4
        for cfg in (child.CFG, child.TILED_CFG):
            scheduler.run_pipeline(dense["one"], cfg, mesh=ref_mesh)
    finally:
        _finish(procs)
    for r in range(2):
        g = torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False)
        assert g["devices"] == [f"cuda:{i}" for i in range(4)]
        assert g["local"] == [2 * r, 2 * r + 1]
    for out in ("ACMMP", "TILED"):
        two, one = (_tree(os.path.join(dense[k], out)) for k in ("two",
                                                                 "one"))
        assert sorted(two) == sorted(one) and len(one) > 0, out
        for k in one:
            assert two[k] == one[k], (out, k)
