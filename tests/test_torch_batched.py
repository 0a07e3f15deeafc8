"""acmmp_tpu_torch's batched executor (view_batch > 1) on the CPU: a batch
of B reference views through one solve, each view against its own
single-view solve, and the port's BatchedSolver against acmmp_tpu's.

Bars. The batched plain ZNCC and geom and the batched solve are bitwise
(torch.equal) equal, view by view, to single-view calls: every
operation is per (view, pixel, hypothesis) or reduces over an axis that
does not hold the batch. The batch holds views whose true source counts
differ (view 1 has a padded slot). Against the JAX package's
BatchedSolver(mesh=None), each view is no worse than either package's
own solve under 1e-5 of ZNCC cost noise, and view 0 meets the bars of
tests/test_torch_solver.py (80% of interior depths within 1%, 97% within
5%), which were measured on it. process_batch keeps the JAX package's
order: it prepares every view of a batch before it writes any (a
multi_geometry pass reads its batch-mates' maps of the previous pass).
The kernels' batched launches run only on a card: the cuda-marked test
holds them bitwise to single-view launches there (`python -m pytest
--noconftest -m cuda tests/test_torch_batched.py`), and chip_smoke.py
phases 3f, 5c and 8b at the main paths' shapes. JAX is imported only where it is installed."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from acmmp_tpu_torch.config import (FusionParams, PatchMatchParams,
                                    PipelineConfig)
from acmmp_tpu_torch.core import geometry as tgeo
from acmmp_tpu_torch.engine import patchmatch as tpm
from acmmp_tpu_torch.engine.inputs import (build_solver_inputs,
                                           solver_inputs_batch_from_numpy)
from acmmp_tpu_torch.ops import geom as tgeom
from acmmp_tpu_torch.ops import keys
from acmmp_tpu_torch.ops import ncc as tncc
from acmmp_tpu_torch.ops import parity as tparity
from acmmp_tpu_torch.ops import sampling as tsamp
from acmmp_tpu_torch.parallel.sharding import stack_solver_inputs
from acmmp_tpu_torch.pipeline import scheduler as tsched
from acmmp_tpu_torch.pipeline.batched import BatchedSolver
from acmmp_tpu_torch.utils.synth import (textured_plane_scene,
                                         write_dense_folder)

try:
    import jax
    import jax.numpy as jnp

    from acmmp_tpu.config import PatchMatchParams as JaxParams
    from acmmp_tpu.engine.inputs import build_solver_inputs as jax_inputs
    from acmmp_tpu.engine.patchmatch import Mode as JaxMode
    from acmmp_tpu.ops import ncc as jncc
    from acmmp_tpu.pipeline.batched import BatchedSolver as JaxBatched

    from .util import textured_plane_scene as jax_scene
except ImportError:      # a card machine without JAX: the card test only
    jax = None

torch.set_num_threads(1)

TP = PatchMatchParams(patch_size=7)
TP_F32 = dataclasses.replace(TP, ncc_src_u8=False)
# view b of the batch: the reference, and its sources (view 1 has two,
# in three slots)
REFS = (0, 1, 2)
SOURCES = {0: (1, 2, 3), 1: (2, 3), 2: (0, 1, 3)}
V_PAD = 3
INTERIOR = np.s_[10:38, 12:52]
# tests/test_torch_solver.py's solve-level bars
SHARE_WITHIN_1PCT = 0.80
SHARE_WITHIN_5PCT = 0.97


def _views(params, device="cpu", **maps):
    """The batch's single-view SolverInputs (64x48, 4-view plane scene),
    and its depth maps (the plane with a gentle tilt per view, for the
    geometric mode)."""
    images, cams, plane_z = textured_plane_scene(n_views=4, width=64,
                                                 height=48)
    out = []
    for b in REFS:
        src = SOURCES[b]
        kw = {k: v(b, src) for k, v in maps.items()}
        out.append(build_solver_inputs(
            images[b], [images[j] for j in src], cams[b],
            [cams[j] for j in src], params, num_views_pad=V_PAD, pad_h=1,
            pad_w=1, device=device, **kw))
    return out, plane_z


def _geom_maps(plane_z):
    x = np.arange(64, dtype=np.float32)[None, :]
    y = np.arange(48, dtype=np.float32)[:, None]

    def depth(j):
        return (plane_z * (1.0 + 0.002 * j + 0.0004 * (x - 32) / 32
                           - 0.0003 * (y - 24) / 24)).astype(np.float32)

    return dict(src_depths=lambda b, src: [depth(j) for j in src],
                init_depth=lambda b, src: depth(b),
                init_normal_world=lambda b, src: np.broadcast_to(
                    np.array([0.0, 0.0, -1.0], np.float32), (48, 64, 3)))


def _planes(inputs, K, seed):
    """K random plane fields per view ([K, H, W, 4] each), the windowed
    law with a cap."""
    H, W = inputs[0].ref_img.shape
    x, y = tgeo.pixel_grid(H, W, device=inputs[0].ref_img.device)
    return [torch.stack([tsamp.random_plane(
        k, inp.ref_cam, x, y, inp.depth_min, inp.depth_max,
        tile_window=0.125, min_cos=0.25)
        for k in keys.split(keys.key(seed + b), K)])
        for b, inp in enumerate(inputs)]


LAYOUTS = [(1, None), (8, 0), (8, 1), (3, 0), (2, 1)]


@pytest.mark.parametrize("src_type", ["u8", "f32"])
@pytest.mark.parametrize("K,off0", LAYOUTS)
def test_plain_zncc_batch_equals_single_views(src_type, K, off0):
    """(a) The plain ZNCC of a batch of 3 views, every K on its layout
    (K=1 full grid, K=8/3/2 parity-packed at both parities), 8-bit and
    float sources: each view torch.equal to its own call."""
    params = TP if src_type == "u8" else TP_F32
    inputs, _ = _views(params)
    assert [int(i.view_mask.sum()) for i in inputs] == [3, 2, 3]
    batch = stack_solver_inputs(inputs)
    vg_b = tncc.make_view_geometry(batch.ref_cam, batch.src_cams)
    planes = _planes(inputs, K, 10 * K)
    if off0 is not None:
        planes = [tparity.pack_rows_c(p, off0) for p in planes]

    def run(ref, src, vg, p):
        if off0 is None:
            return tncc.multiview_zncc(ref, src, vg, p, params)
        return tncc.multiview_zncc_packed(ref, src, vg, p, params, off0)

    got = run(batch.ref_img, batch.src_imgs, vg_b, torch.stack(planes, 1))
    assert got.shape[:2] == (K, len(REFS))
    for b, inp in enumerate(inputs):
        vg = tncc.make_view_geometry(inp.ref_cam, inp.src_cams)
        want = run(inp.ref_img, inp.src_imgs, vg, planes[b])
        assert torch.equal(got[:, b], want), b


@pytest.mark.parametrize("K,off0", [(1, None), (8, 0), (8, 1), (5, 0),
                                    (5, 1)])
def test_plain_geom_batch_equals_single_views(K, off0):
    """(a) The plain geometric cost of a batch of 3 views, K=1 on the full
    grid and K=8/5 packed at both parities, the padded slot's zero depth
    map included: each view torch.equal to its own call."""
    inputs, plane_z = _views(TP, **_geom_maps(5.0))
    batch = stack_solver_inputs(inputs)
    planes = _planes(inputs, K, 20 * K)
    if off0 is not None:
        planes = [tparity.pack_rows_c(p, off0) for p in planes]
    got = tgeom.geom_consistency_cost(
        batch.ref_cam, batch.src_cams, batch.src_depths,
        torch.stack(planes, 1), TP, row_pack_off=off0)
    for b, inp in enumerate(inputs):
        want = tgeom.geom_consistency_cost(
            inp.ref_cam, inp.src_cams, inp.src_depths, planes[b], TP,
            row_pack_off=off0)
        assert torch.equal(got[:, b], want), b
    # informative costs, and geom_cost_max in view 1's padded slot
    assert float(got[..., :2].min()) < TP.geom_cost_max
    assert bool((got[:, 1, ..., 2] == TP.geom_cost_max).all())


@pytest.mark.parametrize("mode", [tpm.Mode(),
                                  tpm.Mode(geom_consistency=True)],
                         ids=["photometric", "geometric"])
def test_solve_batch_equals_run_patchmatch(mode):
    """(b) BatchedSolver.solve_batch of 3 views: each view's depth, world
    normal, cost and pre_costs torch.equal to its own run_patchmatch with
    the same key."""
    maps = _geom_maps(5.0) if mode.geom_consistency else {}
    inputs, _ = _views(TP, **maps)
    ks = [keys.key(40 + b) for b in range(len(inputs))]
    outs = BatchedSolver(TP).solve_batch(inputs, ks, mode)
    for b, (inp, k) in enumerate(zip(inputs, ks)):
        want = tpm.run_patchmatch(inp, k, TP, mode)
        for f in tpm.SolverOutputs._fields:
            assert torch.equal(getattr(outs[b], f), getattr(want, f)), (b, f)
    assert np.isfinite(outs[0].depth.numpy()).all()


def _shares(a, b):
    rel = np.abs(a[INTERIOR] - b[INTERIOR]) / np.abs(b[INTERIOR])
    return (rel < 0.01).mean(), (rel < 0.05).mean()


def test_solve_batch_agrees_with_jax():
    """(c) The port's batched solve against the JAX package's
    BatchedSolver(mesh=None) with the jnp ZNCC, on the same 3 problems
    (views 0, 1, 2, each with its 3 sources) and keys (key(b)). Every
    view is held to two witnesses of how far 1e-5 of ZNCC cost noise
    moves a solve of this scene (tests/test_torch_solver.py's self-noise
    rule): the port's solve against itself under that noise, and the JAX
    package's against itself under the same noise. View 0, that file's
    problem and key, is also held to its bars of 80% within 1% and 97%
    within 5%. Measured (this test, CPU), within 1% and 5%, port vs JAX,
    port vs noisy port, JAX vs noisy JAX: view 0 0.853 / 0.988, 0.838 /
    0.977, 0.834 / 0.980; view 1 0.773 / 0.948, 0.754 / 0.943, 0.735 /
    0.954; view 2 0.770 / 0.954, 0.737 / 0.936, 0.744 / 0.937. On views
    1 and 2 neither package agrees with itself under the noise as well as
    the bars measured on view 0 ask, so those bars do not carry over to
    them: their argmin near-ties flip under 1e-5 of cost in either
    package."""
    if jax is None:
        pytest.skip("needs JAX and acmmp_tpu")
    jp = JaxParams(patch_size=7, ncc_backend="jnp")
    images, cams, _ = jax_scene(n_views=4, width=64, height=48)
    srcs = {b: [j for j in range(4) if j != b] for b in REFS}
    jins = [jax_inputs(images[b], [images[j] for j in srcs[b]], cams[b],
                       [cams[j] for j in srcs[b]], jp, pad_h=1, pad_w=1)
            for b in REFS]
    jkeys = [jax.random.key(b) for b in REFS]
    jouts = JaxBatched(jp).solve_batch(jins, jkeys, JaxMode())
    batch, kb = solver_inputs_batch_from_numpy(
        [jax.tree.map(np.asarray, j) for j in jins],
        [jax.random.key_data(k) for k in jkeys], device="cpu")
    tout = tpm.run_patchmatch_batch(batch, kb, TP)
    clean = tncc._zncc_grids
    gen = torch.Generator().manual_seed(0)

    def noisy(*args):
        cost = clean(*args)
        return cost + 1e-5 * torch.randn(cost.shape, generator=gen)

    tncc._zncc_grids = noisy
    try:
        tnoisy = tpm.run_patchmatch_batch(batch, kb, TP)
    finally:
        tncc._zncc_grids = clean
    # the same noise in the JAX package's jnp ZNCC: a fresh BatchedSolver
    # traces its stage programs anew through the patched function; each
    # traced call draws its own field, salted by its planes so that every
    # view and half-sweep gets another one
    jclean, traced = jncc._zncc_grids, []

    def jnoisy(*args):
        cost = jclean(*args)
        traced.append(None)
        salt = jax.lax.bitcast_convert_type(
            jnp.sum(args[6], dtype=jnp.float32), jnp.uint32)
        k = jax.random.fold_in(jax.random.key(len(traced)), salt)
        return cost + 1e-5 * jax.random.normal(k, cost.shape, cost.dtype)

    jncc._zncc_grids = jnoisy
    try:
        jnoisy_outs = JaxBatched(jp).solve_batch(jins, jkeys, JaxMode())
    finally:
        jncc._zncc_grids = jclean
    assert traced
    for b in range(len(REFS)):
        port = tout.depth[b].numpy()
        jref = np.asarray(jouts[b].depth)
        assert np.isfinite(port).all()
        s1, s5 = _shares(port, jref)
        n1, n5 = _shares(tnoisy.depth[b].numpy(), port)
        j1, j5 = _shares(np.asarray(jnoisy_outs[b].depth), jref)
        seen = (b, s1, s5, n1, n5, j1, j5)
        if b == 0:
            assert s1 >= SHARE_WITHIN_1PCT and s5 >= SHARE_WITHIN_5PCT, seen
        assert s1 >= n1 - 0.05 and s5 >= n5 - 0.02, seen
        assert s1 >= j1 - 0.05 and s5 >= j5 - 0.02, seen


def test_process_batch_reads_every_view_before_writing(tmp_path,
                                                       monkeypatch):
    """(d) process_batch prepares (reads) every view of its batch before
    it writes any view's outputs, as the JAX package's process_batch does,
    and writes each view's .dmb files and pass marker."""
    images, cams, _ = textured_plane_scene(n_views=4, width=64, height=48)
    dense = write_dense_folder(str(tmp_path / "s"), images, cams)
    cfg = PipelineConfig(
        patchmatch=PatchMatchParams(patch_size=7, size_bound=64),
        fusion=FusionParams(num_consistent_thresh=2), pad_h=1, pad_w=1,
        view_batch=4)
    problems = tsched.generate_sample_list(dense)
    tsched.compute_multiscale_settings(dense, problems, cfg.patchmatch)
    for p in problems:
        p.cur_image_size = p.max_image_size
    events = []
    prepare, write = tsched._prepare_problem, tsched._write_outputs

    def logged_prepare(*args, **kw):
        events.append(("read", args[3]))
        return prepare(*args, **kw)

    def logged_write(rdir, *args, **kw):
        events.append(("write", rdir))
        return write(rdir, *args, **kw)

    monkeypatch.setattr(tsched, "_prepare_problem", logged_prepare)
    monkeypatch.setattr(tsched, "_write_outputs", logged_write)
    out = os.path.join(dense, "ACMMP")
    tsched.process_batch(
        dense, out, problems, [0, 1, 2, 3], cfg, tsched.ViewLoader(dense),
        BatchedSolver(cfg.patchmatch), geom_consistency=False,
        planar_prior=True, hierarchy=False, pass_tag=0, device="cpu")
    kinds = [k for k, _ in events]
    assert kinds == ["read"] * 4 + ["write"] * 4, events
    for p in problems:
        rdir = os.path.join(out, f"2333_{p.ref_image_id:08d}")
        for name in ("depths.dmb", "normals.dmb", "costs.dmb",
                     ".pass_000.json"):
            assert os.path.exists(os.path.join(rdir, name)), (rdir, name)


@pytest.mark.cuda
def test_batched_kernels_equal_single_launches_on_card():
    """(e) On the card: each batched launch of zncc.cu (K=1 on the full
    grid, K=8/3/2 packed at both parities, 8-bit and float sources) and
    geom.cu (K=1, 8 and 5) torch.equal to the same views' single-view
    launches, views whose true source counts differ (view 1 has a padded
    slot), one launch for the batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from acmmp_tpu_torch.ops import cuda_geom, cuda_ncc

    for params in (TP, TP_F32):
        inputs, _ = _views(params, device="cuda", **_geom_maps(5.0))
        batch = stack_solver_inputs(inputs)
        nv = [int(i.view_mask.sum()) for i in inputs]
        vg_b = tncc.make_view_geometry(batch.ref_cam, batch.src_cams)
        vgs = [tncc.make_view_geometry(i.ref_cam, i.src_cams)
               for i in inputs]
        for K, off0 in LAYOUTS:
            planes = _planes(inputs, K, 10 * K)
            if off0 is not None:
                planes = [tparity.pack_rows_c(p, off0).contiguous()
                          for p in planes]
            before = cuda_ncc.total_launches()
            got = cuda_ncc.multiview_zncc_cuda(
                batch.ref_img, batch.src_imgs, vg_b,
                torch.stack(planes, 1).contiguous(), params,
                row_pack_off=off0, n_views=nv)
            assert cuda_ncc.total_launches() == before + 1
            for b, inp in enumerate(inputs):
                want = cuda_ncc.multiview_zncc_cuda(
                    inp.ref_img, inp.src_imgs, vgs[b], planes[b], params,
                    row_pack_off=off0, n_views=nv[b])
                assert torch.equal(got[:, b], want), (K, off0, b)
            assert bool((got[:, 1, ..., 2] == params.cost_max).all())
        if params is TP_F32:
            continue
        for K, off0 in ((1, None), (8, 0), (8, 1), (5, 0), (5, 1)):
            planes = _planes(inputs, K, 20 * K)
            if off0 is not None:
                planes = [tparity.pack_rows_c(p, off0).contiguous()
                          for p in planes]
            before = cuda_geom.total_launches()
            got = cuda_geom.geom_consistency_cost_cuda(
                batch.ref_cam, batch.src_cams, batch.src_depths,
                torch.stack(planes, 1).contiguous(), params,
                row_pack_off=off0, n_views=nv)
            assert cuda_geom.total_launches() == before + 1
            for b, inp in enumerate(inputs):
                want = cuda_geom.geom_consistency_cost_cuda(
                    inp.ref_cam, inp.src_cams, inp.src_depths, planes[b],
                    params, row_pack_off=off0, n_views=nv[b])
                assert torch.equal(got[:, b], want), (K, off0, b)
