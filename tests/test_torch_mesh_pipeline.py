"""acmmp_tpu_torch's run_pipeline on a device mesh of repeated CPU
devices (pipeline/scheduler.py's mesh branches).

The tiled pipeline (tests/test_tiles.py::test_pipeline_dispatches_tile_
sharding, one geometric pass): with tile_pixels below the views' size
and a 2-member mesh, every solve (photometric, planar-prior second
solve, geometric) goes through tile_sharded_patchmatch on views whose
40 rows the tiled plan pads to 48, and each view's depths_geom.dmb
equals the unmeshed pipeline's (40 rows, unpadded) exactly (with one
geometric pass fusion keeps no point of this scene in either, so the
depth maps are the evidence, as in the JAX test). The view-sharded
pipeline (tile_pixels 0, two geometric passes): a batch of the 4 views
over 2 members writes the .dmb files of the batched executor at
view_batch=4, bit for bit (both read every view of a pass before
writing any), its geometric passes read no source depth file (each
view's own map twice: its re-entry depth and its slot of the bank), and
its grouped fusion writes the sequential fusion's PLY bytes."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from acmmp_tpu_torch.config import (FusionParams, PatchMatchParams,
                                    PipelineConfig)
from acmmp_tpu_torch.engine.fusion import run_fusion
from acmmp_tpu_torch.io import read_dmb, read_ply
from acmmp_tpu_torch.parallel import make_view_mesh, tiles
from acmmp_tpu_torch.pipeline import scheduler
from acmmp_tpu_torch.utils.synth import (textured_plane_scene,
                                         write_dense_folder)

torch.set_num_threads(1)

N_VIEWS = 4
# one iteration (two half-sweeps) per solve keeps the file's four
# pipelines short; the bars are equalities, at any count
CFG = PipelineConfig(patchmatch=PatchMatchParams(patch_size=7,
                                                 max_iterations=1),
                     fusion=FusionParams(num_consistent_thresh=2),
                     pad_h=1, pad_w=1, geom_iterations=1)


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    # 40 rows: the tiled plan pads them to 48 (a multiple of 8 x 2
    # members), the unmeshed pipeline keeps 40
    images, cams, plane_z = textured_plane_scene(n_views=N_VIEWS, width=64,
                                                 height=40)
    return write_dense_folder(str(tmp_path_factory.mktemp("mesh") / "s"),
                              images, cams), plane_z


def _depths(dense, out):
    return [read_dmb(os.path.join(dense, out, f"2333_{v:08d}",
                                  "depths_geom.dmb"))
            for v in range(N_VIEWS)]


def test_pipeline_dispatches_tile_sharding(dense, monkeypatch):
    dense, plane_z = dense
    cfg = dataclasses.replace(CFG, tile_pixels=1000)   # 64*40 > 1000
    calls = []
    real = tiles.tile_sharded_patchmatch

    def counting(mesh_, inputs, key, params, mode):
        calls.append((tuple(inputs.ref_img.shape), mode))
        return real(mesh_, inputs, key, params, mode)

    monkeypatch.setattr(tiles, "tile_sharded_patchmatch", counting)
    ply = scheduler.run_pipeline(dense, cfg,
                                 mesh=make_view_mesh(devices=["cpu"] * 2))
    modes = [m for _, m in calls]
    # photometric + prior second solves + one geometric pass, 4 views
    assert sum(1 for m in modes if m.planar_prior) >= 1
    assert sum(1 for m in modes if m.geom_consistency) == N_VIEWS
    assert len(calls) >= 2 * N_VIEWS + 1, len(calls)
    for shape, _ in calls:
        assert shape[0] == 48, shape     # padded for 2 members
    assert os.path.exists(ply)

    run_u = dataclasses.replace(CFG, tile_pixels=0, output_dir="ACMMP_U",
                                fusion_dir="ACMMP_U")
    scheduler.run_pipeline(dense, run_u, device="cpu")
    for v, (d_t, d_u) in enumerate(zip(_depths(dense, "ACMMP"),
                                       _depths(dense, "ACMMP_U"))):
        assert d_t.shape == (40, 64)
        np.testing.assert_array_equal(d_t, d_u, err_msg=f"view {v}")


def test_view_sharded_pipeline(dense, monkeypatch):
    dense, plane_z = dense
    reads = []
    real_read = scheduler.read_dmb

    def counting_read(path):
        reads.append(path)
        return real_read(path)

    mesh_cfg = dataclasses.replace(CFG, tile_pixels=0, geom_iterations=2,
                                   view_batch=N_VIEWS, output_dir="MESH",
                                   fusion_dir="MESH")
    monkeypatch.setattr(scheduler, "read_dmb", counting_read)
    ply = scheduler.run_pipeline(dense, mesh_cfg,
                                 mesh=make_view_mesh(devices=["cpu"] * 2))
    monkeypatch.setattr(scheduler, "read_dmb", real_read)
    # each geometric pass reads each view's own map twice (its re-entry
    # depth and its bank slot) and no problem's sources
    for name in ("depths.dmb", "depths_geom.dmb"):
        geom_reads = [p for p in reads if p.endswith(name)]
        assert len(geom_reads) == 2 * N_VIEWS, (name, geom_reads)
        assert all(geom_reads.count(p) == 2 for p in geom_reads)

    batch_cfg = dataclasses.replace(mesh_cfg, output_dir="BATCH",
                                    fusion_dir="BATCH")
    scheduler.run_pipeline(dense, batch_cfg, device="cpu")
    for name in ("depths.dmb", "depths_geom.dmb", "normals.dmb",
                 "costs.dmb"):
        for v in range(N_VIEWS):
            a, b = (read_dmb(os.path.join(dense, out, f"2333_{v:08d}", name))
                    for out in ("MESH", "BATCH"))
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {v}")
    # grouped fusion: the sequential fusion's PLY bytes
    out = os.path.join(dense, "MESH")
    seq = run_fusion(dense, out, scheduler.generate_sample_list(dense),
                     geom_consistency=True, fp=CFG.fusion,
                     ply_name="seq.ply", device="cpu")
    with open(ply, "rb") as f, open(seq, "rb") as g:
        assert f.read() == g.read()
    pts = read_ply(ply)[0]
    assert len(pts) > 0       # 18 at this size and one scale
    assert np.median(np.abs(pts[:, 2] - plane_z)) < 0.1


@pytest.mark.cuda
def test_mesh_of_cards_equals_one_card(tmp_path):
    """On a host with several cards: the view mesh of every card writes
    the .dmb files and PLY bytes of the same mesh repeated on cuda:0 (its
    halos, depth banks and fusion parts then move between cards), and the
    tiled pipeline over every card writes the unmeshed pipeline's
    depths_geom.dmb."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a host with at least two CUDA devices")
    n_cards = torch.cuda.device_count()
    # 96 rows: 24 per member on up to four cards, the halo's reach
    images, cams, plane_z = textured_plane_scene(n_views=N_VIEWS, width=128,
                                                 height=96)
    dense = write_dense_folder(str(tmp_path / "s"), images, cams)
    base = dataclasses.replace(CFG, tile_pixels=0, geom_iterations=2,
                               view_batch=N_VIEWS)
    plys = {}
    for name, mesh in (("CARDS", make_view_mesh()),
                       ("ONE", make_view_mesh(devices=["cuda:0"] * n_cards))):
        assert len(mesh) == n_cards
        plys[name] = scheduler.run_pipeline(dense, dataclasses.replace(
            base, output_dir=name, fusion_dir=name), mesh=mesh)
    for name in ("depths.dmb", "depths_geom.dmb", "normals.dmb",
                 "costs.dmb"):
        for v in range(N_VIEWS):
            a, b = (read_dmb(os.path.join(dense, out, f"2333_{v:08d}", name))
                    for out in ("CARDS", "ONE"))
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {v}")
    with open(plys["CARDS"], "rb") as f, open(plys["ONE"], "rb") as g:
        assert f.read() == g.read()
    assert len(read_ply(plys["CARDS"])[0]) > 0

    tiled = dataclasses.replace(CFG, tile_pixels=1000, output_dir="TILED",
                                fusion_dir="TILED")
    scheduler.run_pipeline(dense, tiled, mesh=make_view_mesh())
    scheduler.run_pipeline(dense, dataclasses.replace(
        tiled, tile_pixels=0, output_dir="UNTILED", fusion_dir="UNTILED"),
        device="cuda:0")
    for v, (d_t, d_u) in enumerate(zip(_depths(dense, "TILED"),
                                       _depths(dense, "UNTILED"))):
        np.testing.assert_array_equal(d_t, d_u, err_msg=f"view {v}")
