"""acmmp_tpu_torch's view mesh (parallel/sharding.py), its batched
executor on a mesh and grouped fusion, on meshes of repeated CPU devices.

The view-sharded solves (a 3-view batch padded to 4 for 2 members) equal
each view's own run_patchmatch bitwise, photometric and geometric (the
JAX tests/test_parallel.py holds its sharded solves to 2% of pixels:
XLA fuses differently by local batch; the port's batch is bitwise per
view). pad_to_multiple and gather_src_depths equal the JAX package's
functions. Grouped fusion (plain, prior-aware and mixed resolution)
equals the port's sequential fusion bitwise, and the JAX package's
fuse_views(mesh=...) on the fixture of tests/test_parallel.py. The
geometric pass's depth bank reads each view's .dmb at most once per
pass across shape buckets and batches, and equals direct disk reads.
The mesh pipelines are in tests/test_torch_mesh_pipeline.py."""

import os

import numpy as np
import pytest
import torch

from acmmp_tpu_torch.config import FusionParams, PatchMatchParams
from acmmp_tpu_torch.engine.fusion import FusionView, fuse_views
from acmmp_tpu_torch.engine.inputs import build_solver_inputs
from acmmp_tpu_torch.engine.patchmatch import (Mode, SolverOutputs,
                                               run_patchmatch, view_of)
from acmmp_tpu_torch.io import write_dmb
from acmmp_tpu_torch.io.dense_folder import Problem, result_dir
from acmmp_tpu_torch.ops import keys
from acmmp_tpu_torch.parallel import (make_view_mesh, pad_to_multiple,
                                      stack_solver_inputs,
                                      view_sharded_geometric_solve,
                                      view_sharded_solve)
from acmmp_tpu_torch.parallel.sharding import gather_src_depths
from acmmp_tpu_torch.pipeline import scheduler
from acmmp_tpu_torch.pipeline.batched import BatchedSolver
from acmmp_tpu_torch.utils.synth import textured_plane_scene

torch.set_num_threads(1)

PARAMS = PatchMatchParams(max_iterations=1)
FP = FusionParams(num_consistent_thresh=2)


def _mesh(n):
    return make_view_mesh(devices=["cpu"] * n)


def _joined(shards):
    """The member shards of a sharded solve as one batch."""
    return SolverOutputs(*(torch.cat(fs) for fs in zip(*shards)))


@pytest.fixture(scope="module")
def batch():
    """tests/test_parallel.py's batch: 3 views of a 64x32 plane scene,
    each with the other two as sources, one key each."""
    n_views = 3
    images, cams, plane_z = textured_plane_scene(n_views=n_views, width=64,
                                                 height=32)
    problems, src_idx = [], []
    for i in range(n_views):
        srcs = [j for j in range(n_views) if j != i]
        problems.append(build_solver_inputs(
            images[i], [images[j] for j in srcs], cams[i],
            [cams[j] for j in srcs], PARAMS, device="cpu"))
        src_idx.append(srcs)
    ks = keys.split(keys.key(7), n_views)
    return problems, ks, np.asarray(src_idx)


def test_view_sharded_solves_equal_per_view_solves(batch):
    """3 views padded to 4 over 2 members: the photometric pass, then the
    geometric pass on its depth maps through the bank, each view bitwise
    its own solve; the padding repeats the last view and is invalid."""
    problems, ks, src_idx = batch
    n = len(problems)
    mesh = _mesh(2)
    pb, pk, valid = pad_to_multiple(stack_solver_inputs(problems),
                                    keys.stack(ks), len(mesh))
    assert pb.ref_img.shape[0] == len(pk) == 4
    assert valid.tolist() == [True, True, True, False]
    shards = view_sharded_solve(mesh, pb, pk, PARAMS, Mode())
    assert [s.depth.shape[0] for s in shards] == [2, 2]
    out = _joined(shards)
    singles = [run_patchmatch(p, k, PARAMS) for p, k in zip(problems, ks)]
    for j in range(4):
        want = singles[min(j, n - 1)]
        for name in want._fields:
            assert torch.equal(getattr(view_of(out, j), name),
                               getattr(want, name)), (j, name)

    # the geometric pass: the current maps as the bank, sources gathered
    Hs, Ws = pb.src_imgs.shape[-2:]
    depth_maps = out.depth[:, :Hs, :Ws]
    geom_batch = pb._replace(init_depth=out.depth,
                             init_normal_world=out.normal_world,
                             init_cost=out.cost)
    psrc = np.concatenate([src_idx, src_idx[-1:]])
    k2 = keys.fold_in(pk, 1)
    mode = Mode(geom_consistency=True)
    got = _joined(view_sharded_geometric_solve(
        mesh, geom_batch, [depth_maps[:2], depth_maps[2:]],
        torch.as_tensor(psrc), k2, PARAMS, mode))
    for j in range(n):
        inp = view_of(geom_batch, j)._replace(
            src_depths=depth_maps[torch.as_tensor(psrc[j])])
        want = run_patchmatch(inp, keys.from_key_data(k2.words[j]), PARAMS,
                              mode)
        for name in want._fields:
            assert torch.equal(getattr(view_of(got, j), name),
                               getattr(want, name)), (j, name)
    assert torch.isfinite(got.depth).all()


def test_batched_solver_on_mesh(batch):
    """BatchedSolver(mesh=...) pads to the mesh, drops the padding and
    gives each view its own solve."""
    problems, ks, _ = batch
    solver = BatchedSolver(PARAMS, _mesh(2))
    assert [solver.padded_size(n) for n in (1, 2, 3)] == [2, 2, 4]
    outs = solver.solve_batch(problems, ks, Mode())
    assert len(outs) == len(problems)
    for p, k, o in zip(problems, ks, outs):
        assert torch.equal(o.depth, run_patchmatch(p, k, PARAMS).depth)


def test_pad_and_gather_match_jax(batch):
    import jax
    import jax.numpy as jnp

    from acmmp_tpu.parallel import make_view_mesh as jax_mesh
    from acmmp_tpu.parallel import pad_to_multiple as jax_pad
    from acmmp_tpu.parallel.sharding import (gather_src_depths as
                                             jax_gather)

    # pad_to_multiple: the same padded fields, keys and valid mask
    problems, ks, _ = batch
    jb = {"ref_img": jnp.stack([jnp.asarray(p.ref_img.numpy())
                                for p in problems]),
          "depth_min": jnp.stack([jnp.asarray(p.depth_min.numpy())
                                  for p in problems])}
    jkeys = jax.random.split(jax.random.key(7), 3)
    jpb, jpk, jvalid = jax_pad(jb, jkeys, 4)
    pb, pk, valid = pad_to_multiple(stack_solver_inputs(problems),
                                    keys.stack(ks), 4)
    np.testing.assert_array_equal(pb.ref_img.numpy(),
                                  np.asarray(jpb["ref_img"]))
    np.testing.assert_array_equal(pb.depth_min.numpy(),
                                  np.asarray(jpb["depth_min"]))
    np.testing.assert_array_equal(pk.words, np.asarray(
        jax.random.key_data(jpk)))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert pb.ref_cam.K.shape[0] == pb.src_cams.K.shape[0] == 4

    # gather_src_depths: tests/test_parallel.py's collective on 4 members
    rng = np.random.default_rng(3)
    maps = rng.uniform(1.0, 9.0, (8, 16, 128)).astype(np.float32)
    si = rng.integers(0, 8, (4, 5)).astype(np.int32)
    want = np.asarray(jax_gather(jax_mesh(devices=jax.devices()[:4]),
                                 jnp.asarray(maps), jnp.asarray(si)))
    got = gather_src_depths(_mesh(4), torch.as_tensor(maps),
                            torch.as_tensor(si))
    assert [g.shape[0] for g in got] == [1] * 4
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)
    np.testing.assert_array_equal(want, maps[si])


def _fusion_views(kind, n_views=4):
    images, cams, plane_z = textured_plane_scene(n_views=n_views, width=64,
                                                 height=48)
    views = {}
    for i in range(n_views):
        h, w = (24, 32) if kind == "mixed" and i == 3 else (48, 64)
        depth = np.full((h, w), plane_z, np.float32)
        normal = np.zeros((h, w, 3), np.float32)
        normal[..., 2] = -1.0
        img = np.stack([images[i]] * 3, axis=-1).astype(np.float32)
        kw = {}
        if kind == "dual":
            # second candidate: consistent only in the left half
            depth1 = depth.copy()
            depth1[:, 32:] += 3.0
            kw = dict(depth1=depth1, normal1=normal.copy())
        views[i] = FusionView(img, cams[i], depth, normal, **kw)
    problems = [Problem(ref_image_id=i,
                        src_image_ids=[j for j in range(n_views) if j != i])
                for i in range(n_views)]
    return views, problems, plane_z


@pytest.mark.parametrize("kind,n", [("plain", 2), ("plain", 4),
                                    ("mixed", 3), ("dual", 2)])
def test_grouped_fusion_equals_sequential(kind, n):
    """Groups of mesh size scored per member, the greedy chain replayed
    on the host: the sequential cloud bit for bit (plain, a half-size
    view, dual candidates)."""
    kw = (dict(prior_aware=True, single_match_penalty=1) if kind == "dual"
          else {})
    views, problems, plane_z = _fusion_views(kind)
    seq = fuse_views(views, problems, FP, device="cpu", **kw)
    views, problems, _ = _fusion_views(kind)
    grouped = fuse_views(views, problems, FP, mesh=_mesh(n), **kw)
    assert len(seq[0]) > 0
    for a, b in zip(seq, grouped):
        np.testing.assert_array_equal(a, b)
    assert np.median(np.abs(seq[0][:, 2] - plane_z)) < 0.1


def test_grouped_fusion_matches_jax():
    """The fixture of tests/test_parallel.py through the JAX package's
    fuse_views(mesh=...) and the port's, bitwise."""
    import jax

    from acmmp_tpu.config import FusionParams as JaxFusionParams
    from acmmp_tpu.engine.fusion import FusionView as JaxView
    from acmmp_tpu.engine.fusion import fuse_views as jax_fuse
    from acmmp_tpu.io.dense_folder import Problem as JaxProblem
    from acmmp_tpu.parallel import make_view_mesh as jax_mesh

    views, problems, _ = _fusion_views("plain")
    jviews = {i: JaxView(v.image, v.cam, v.depth, v.normal)
              for i, v in views.items()}
    jproblems = [JaxProblem(ref_image_id=p.ref_image_id,
                            src_image_ids=p.src_image_ids)
                 for p in problems]
    want = jax_fuse(jviews, jproblems,
                    JaxFusionParams(num_consistent_thresh=2),
                    mesh=jax_mesh(devices=jax.devices()[:2]))
    got = fuse_views(views, problems, FP, mesh=_mesh(2))
    assert len(got[0]) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_gathered_depth_bank_mixed_shapes(tmp_path, monkeypatch):
    """tests/test_parallel.py's mixed-shape bank: the collective runs for
    every shape bucket, each view's depth file is read once per pass
    across buckets and batches, and the attached maps equal the files."""
    mesh = _mesh(2)
    out_folder = str(tmp_path)
    rng = np.random.default_rng(5)
    shapes = {0: (16, 24), 1: (16, 24), 2: (32, 40), 3: (32, 40)}
    depths = {i: rng.uniform(1.0, 9.0, shapes[i]).astype(np.float32)
              for i in shapes}
    for i, d in depths.items():
        os.makedirs(result_dir(out_folder, i), exist_ok=True)
        write_dmb(os.path.join(result_dir(out_folder, i), "depths.dmb"), d)
    problems = [Problem(ref_image_id=0, src_image_ids=[1]),
                Problem(ref_image_id=1, src_image_ids=[0]),
                Problem(ref_image_id=2, src_image_ids=[0, 1, 3]),
                Problem(ref_image_id=3, src_image_ids=[0, 1, 2])]

    class FakeInputs:
        def __init__(self, hs, ws, v, src_depths=None):
            self.src_imgs = torch.zeros((v, hs, ws))
            self.ref_img = torch.zeros((hs, ws))
            self.src_depths = src_depths

        def _replace(self, src_depths):
            v, hs, ws = self.src_imgs.shape
            return FakeInputs(hs, ws, v, src_depths)

    class FakePrep:
        def __init__(self, problem, hs, ws, v_pad, tiled=False):
            self.problem = problem
            self.v_pad = v_pad
            self.tiled = tiled
            self.inputs = FakeInputs(hs, ws, v_pad)

    v_pad = 3
    # the small views batch over the mesh (a bank each member gathers
    # from); the large ones are tiled (their maps attached to them)
    preps = [FakePrep(problems[0], 16, 24, v_pad),
             FakePrep(problems[1], 16, 24, v_pad),
             FakePrep(problems[2], 32, 40, v_pad, tiled=True),
             FakePrep(problems[3], 32, 40, v_pad, tiled=True)]
    groups = {(16, 24): preps[:2], (32, 40): preps[2:]}
    reads = []
    real_read = scheduler.read_dmb

    def counting_read(path):
        reads.append(path)
        return real_read(path)

    monkeypatch.setattr(scheduler, "read_dmb", counting_read)
    cache = {}
    banks = scheduler._src_depth_banks(groups, problems, out_folder, mesh,
                                       False, cache=cache)
    n_first = len(reads)
    # a second batch of the same pass: no new read
    again = scheduler._src_depth_banks(
        {(16, 24): [FakePrep(problems[0], 16, 24, v_pad)]}, problems,
        out_folder, mesh, False, cache=cache)
    assert len(reads) == n_first == len(problems), reads
    assert list(banks) == [(16, 24)] and list(again) == [(16, 24)]
    shards, si = banks[(16, 24)]
    assert [s.shape[0] for s in shards] == [2, 2]      # 4 views, 2 members

    for j, pp in enumerate(preps):
        hs, ws = pp.inputs.src_imgs.shape[1:]
        if pp.tiled:
            got = pp.inputs.src_depths.numpy()
        else:
            assert pp.inputs.src_depths is None
            got = torch.cat(shards)[si[j]].numpy()
        assert got.shape == (v_pad, hs, ws)
        for k, s in enumerate(pp.problem.src_image_ids):
            want = np.pad(depths[s], ((0, hs - depths[s].shape[0]),
                                      (0, ws - depths[s].shape[1])))
            np.testing.assert_array_equal(got[k], want)


def _assert_placed(mesh, members):
    for dev, mi in zip(mesh, members):
        for name, f in zip(mi._fields, mi):
            for t in (f if isinstance(f, tuple) else (f,)):
                if torch.is_tensor(t):
                    assert t.device == dev, (name, t.device, dev)


def _fake_members(calls):
    """A stand-in for run_patchmatch_members that records each call's
    mode and member inputs and returns a flat plane at depth 5 whose cost
    triangulates (on the CPU, so that a member on the meta device needs
    no data)."""
    def run(batches, keys_list, params, mode):
        calls.append((mode, batches))
        outs = []
        for b in batches:
            n, h, w = b.ref_img.shape
            normal = torch.zeros((n, h, w, 3))
            normal[..., 2] = -1.0
            outs.append(SolverOutputs(
                depth=torch.full((n, h, w), 5.0), normal_world=normal,
                cost=torch.full((n, h, w), 0.05),
                pre_costs=torch.full((n, h, w), 0.05)))
        return outs
    return run


def test_mesh_members_hold_their_inputs(tmp_path, monkeypatch):
    """On a mesh of distinct devices (here the CPU and the meta device,
    standing in for two cards) every field of member m's inputs sits on
    mesh[m] in a geometric pass of the scheduler: the batched first solve
    and its planar-prior second solve, each member's source depth maps
    gathered from the pass's bank onto its own device. (No data leaves
    the meta device, so the gather is stood in for by one that checks
    where the bank's shards sit and returns zero maps on each member's
    device; the gather itself is test_pad_and_gather_match_jax's.)"""
    from acmmp_tpu_torch.config import PipelineConfig
    from acmmp_tpu_torch.parallel import sharding
    from acmmp_tpu_torch.utils.synth import write_dense_folder

    n_views = 3                            # padded to 4 for 2 members
    images, cams, _ = textured_plane_scene(n_views=n_views, width=64,
                                           height=48)
    dense = write_dense_folder(str(tmp_path / "s"), images, cams)
    out_folder = os.path.join(dense, "ACMMP")
    for i in range(n_views):
        rdir = result_dir(out_folder, i)
        os.makedirs(rdir, exist_ok=True)
        normal = np.zeros((48, 64, 3), np.float32)
        normal[..., 2] = -1.0
        write_dmb(os.path.join(rdir, "depths.dmb"),
                  np.full((48, 64), 5.0, np.float32))
        write_dmb(os.path.join(rdir, "normals.dmb"), normal)
        write_dmb(os.path.join(rdir, "costs.dmb"),
                  np.full((48, 64), 0.1, np.float32))
    calls = []
    monkeypatch.setattr(sharding, "run_patchmatch_members",
                        _fake_members(calls))
    mesh = make_view_mesh(devices=["cpu", "meta"])

    def gather(mesh_, bank, src_idx):
        assert [b.device for b in bank] == list(mesh_)
        hs, ws = bank[0].shape[1:]
        return [torch.zeros((len(i), src_idx.shape[1], hs, ws), device=d)
                for d, i in zip(mesh_, src_idx.chunk(len(mesh_)))]

    monkeypatch.setattr(sharding, "gather_src_depths", gather)
    cfg = PipelineConfig(patchmatch=PARAMS, pad_h=1, pad_w=1)
    problems = scheduler.generate_sample_list(dense)
    for p in problems:
        p.cur_image_size = p.max_image_size
    scheduler.process_batch(
        dense, out_folder, problems, list(range(n_views)), cfg,
        scheduler.ViewLoader(dense, cfg.image_dir),
        BatchedSolver(PARAMS, mesh),
        geom_consistency=True, planar_prior=True, hierarchy=False,
        device="cpu", depth_cache={})
    assert [m.planar_prior for m, _ in calls] == [False, True]
    for _, members in calls:
        assert [mi.ref_img.shape[0] for mi in members] == [2, 2]
        assert all(mi.src_depths is not None for mi in members)
        _assert_placed(mesh, members)

    # the placement check itself refuses a member off its device
    members = sharding.shard_batch(mesh, stack_solver_inputs(
        [build_solver_inputs(images[0], images[1:], cams[0], cams[1:],
                             PARAMS, device="cpu")] * 2))
    sharding.check_placement(mesh, members)
    with pytest.raises(ValueError, match="not on its device"):
        sharding.check_placement(mesh, members[::-1])


def test_view_mesh_without_cuda_raises(monkeypatch):
    """No fallback: the default mesh is the visible CUDA devices."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_view_mesh()
    with pytest.raises(ValueError, match="at least one device"):
        make_view_mesh(devices=[])
    mesh = make_view_mesh(devices=["cpu"] * 3)
    assert list(mesh) == [torch.device("cpu")] * 3
