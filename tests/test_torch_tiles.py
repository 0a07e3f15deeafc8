"""acmmp_tpu_torch's tile-sharded solve (parallel/tiles.py) on meshes of
repeated CPU devices, and the tile origin of the geometric cost.

The port's tiled solve is bitwise equal to its untiled run_patchmatch in
every solver mode and with the windowed depth law on (the asserts of
tests/test_tiles.py, exact here as there): the draws are keyed on image
coordinates, each member's grid sits at its tile origin, and the outer
reference halos replicate the border rows. The halo exchange is checked
alone (zeros, edge replicate), and one tiled solve is held against the
JAX package's tile_sharded_patchmatch (jnp backend, a 2-device mesh) at
the solve-level bars of tests/test_torch_solver.py (80% of interior
depths within 1%, 97% within 5%; measured here at one iteration: 96.8%
and 100%). The plain geometric cost at a tile
origin meets the JAX oracle on the same offset grid at 1e-4, full and
packed; the cuda-marked test holds geom.cu at an origin bitwise to its
plain version on a card."""

import functools

import numpy as np
import pytest
import torch

from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.core import geometry as tgeo
from acmmp_tpu_torch.engine.inputs import (build_solver_inputs,
                                           solver_inputs_from_numpy)
from acmmp_tpu_torch.engine.patchmatch import Mode, run_patchmatch
from acmmp_tpu_torch.engine.priors import build_planar_prior
from acmmp_tpu_torch.ops import geom as tgeom
from acmmp_tpu_torch.ops import keys
from acmmp_tpu_torch.ops import parity as tparity
from acmmp_tpu_torch.parallel import tiles
from acmmp_tpu_torch.utils.synth import textured_plane_scene

try:
    import jax
    import jax.numpy as jnp

    from acmmp_tpu.config import PatchMatchParams as JaxParams
    from acmmp_tpu.core import geometry as jgeo
    from acmmp_tpu.engine.inputs import build_solver_inputs as jax_inputs
    from acmmp_tpu.engine.patchmatch import Mode as JaxMode
    from acmmp_tpu.ops import parity as jparity
    from acmmp_tpu.ops.geom import geom_consistency_cost as jax_geom
    from acmmp_tpu.parallel.tiles import (make_tile_mesh as jax_tile_mesh,
                                          tile_sharded_patchmatch as jax_tiled)

    from .util import textured_plane_scene as jax_scene
except ImportError:      # a card machine without JAX: the card test only
    jax = None

torch.set_num_threads(1)

PARAMS = PatchMatchParams(patch_size=7, max_iterations=1)
WINDOWED = PatchMatchParams(patch_size=7, max_iterations=1,
                            rand_depth_tile_window=0.125,
                            rand_window_min_tiles=6)
CPU2, CPU4 = ["cpu"] * 2, ["cpu"] * 4
# solve-level bars of tests/test_torch_solver.py
SHARE_WITHIN_1PCT, SHARE_WITHIN_5PCT = 0.80, 0.97


def _height(n):
    """tests/test_tiles.py's height for n members: a multiple of 8 n with
    at least HALO rows per member."""
    h = max(tiles.HALO * n, 16 * n)
    return -(-h // (8 * n)) * (8 * n)


def _true_planes(cam, h, w, plane_z):
    x, y = tgeo.pixel_grid(h, w)
    n_cam = tgeo.normal_world_to_cam(
        cam, torch.tensor([0.0, 0.0, -1.0]).expand(h, w, 3))
    return tgeo.plane_from_depth_normal(cam, x, y,
                                        torch.full((h, w), plane_z), n_cam)


@functools.lru_cache(maxsize=None)
def _scene(n, width=128, n_views=4):
    """The plane scene at n members' height, its photometric inputs and
    the port's untiled photometric solve of them."""
    H = _height(n)
    images, cams, plane_z = textured_plane_scene(n_views=n_views,
                                                 width=width, height=H)
    params = WINDOWED if width == 256 else PARAMS
    inp = build_solver_inputs(images[0], images[1:], cams[0], cams[1:],
                              params, pad_h=8, pad_w=128, device="cpu")
    out = run_patchmatch(inp, keys.key(0), params)
    return images, cams, plane_z, inp, out


def _mode_inputs(case, n):
    """(inputs, mode, params) of one solver mode on the n-member scene,
    built from the port's photometric solve as the scheduler builds its
    passes' inputs."""
    if case == "windowed":
        images, cams, plane_z, inp, _ = _scene(n, width=256, n_views=3)
        return inp, Mode(), WINDOWED
    images, cams, plane_z, inp, out = _scene(n)
    if case == "photometric":
        return inp, Mode(), PARAMS
    H, W = inp.ref_img.shape
    depth, cost = out.depth.numpy(), out.cost.numpy()
    kw = dict(init_depth=depth, init_normal_world=out.normal_world.numpy())
    mode = {"geometric": Mode(geom_consistency=True),
            "hierarchy": Mode(hierarchy=True),
            "planar_prior": Mode(planar_prior=True),
            "seeded": Mode(seeded=True)}[case]
    if case == "geometric":
        kw["src_depths"] = [depth * (1.0 + 0.002 * j) for j in range(1, 4)]
    elif case == "hierarchy":
        kw["pre_costs"] = cost + 0.3
    elif case == "planar_prior":
        dmin = float(cams[0].depth_min * PARAMS.depth_min_relax)
        dmax = float(cams[0].depth_max * PARAMS.depth_max_relax)
        h, w = images[0].shape
        planes, mask = build_planar_prior(cams[0], depth[:h, :w],
                                          cost[:h, :w], dmin, dmax, w, h)
        assert planes is not None
        kw.update(init_cost=cost, prior_planes=planes, prior_mask=mask)
    else:
        kw = dict(seed_planes=_true_planes(inp.ref_cam, H, W,
                                           plane_z).numpy())
    full = build_solver_inputs(images[0], images[1:], cams[0], cams[1:],
                               PARAMS, pad_h=8, pad_w=128, device="cpu", **kw)
    return full, mode, PARAMS


@pytest.mark.parametrize("case,n", [
    ("photometric", 2), ("photometric", 4), ("geometric", 2),
    ("hierarchy", 2), ("planar_prior", 2), ("seeded", 2), ("windowed", 2)])
def test_tiled_equals_untiled(case, n):
    """tests/test_tiles.py's bitwise bar in every mode: depth, normal,
    cost and pre_costs of the tiled solve torch.equal to run_patchmatch's
    with the same key."""
    inp, mode, params = _mode_inputs(case, n)
    if case == "windowed":
        from acmmp_tpu_torch.engine.patchmatch import effective_params

        H, W = inp.ref_img.shape
        assert effective_params(params, H, W).rand_depth_tile_window > 0
    key = keys.key(3)
    got = tiles.tile_sharded_patchmatch(tiles.make_tile_mesh(
        devices=["cpu"] * n), inp, key, params, mode)
    want = run_patchmatch(inp, key, params, mode)
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    if case != "windowed":   # 3 views and one iteration: no quality bar
        plane_z, H = _scene(n)[2], _height(n)
        err = (got.depth[6:H - 6, 12:116] - plane_z).abs()
        assert float(err.median()) < 0.15


def test_tiled_rejects_thin_or_ragged_tiles():
    inp, mode, params = _mode_inputs("photometric", 2)
    thin = inp._replace(ref_img=inp.ref_img[:32])
    with pytest.raises(ValueError, match="at least 24 rows"):
        tiles.tile_sharded_patchmatch(tiles.make_tile_mesh(devices=CPU2),
                                      thin, keys.key(0), params, mode)
    ragged = inp._replace(ref_img=inp.ref_img[:40])
    with pytest.raises(ValueError, match="multiple of 8"):
        tiles.tile_sharded_patchmatch(tiles.make_tile_mesh(devices=CPU2),
                                      ragged, keys.key(0), params, mode)


@pytest.mark.parametrize("edge_replicate", [False, True])
def test_halo_exchange(edge_replicate):
    """Members' halos: the neighbours' last / first HALO rows; at the
    outer edges zeros, or the member's own border row repeated."""
    H = tiles.HALO
    rows = [torch.arange(m * 2 * H, (m + 1) * 2 * H,
                         dtype=torch.float32).reshape(1, 2 * H, 1)
            .expand(1, 2 * H, 3) for m in range(3)]
    halos = tiles._exchange_halos(rows, edge_replicate=edge_replicate)
    for m, (top, bot) in enumerate(halos):
        assert top.shape == bot.shape == (1, H, 3)
        if m > 0:
            assert torch.equal(top, rows[m - 1][:, -H:])
        if m < 2:
            assert torch.equal(bot, rows[m + 1][:, :H])
    fill_top = rows[0][:, :1].expand(1, H, 3) if edge_replicate else 0
    fill_bot = rows[2][:, -1:].expand(1, H, 3) if edge_replicate else 0
    assert torch.equal(halos[0][0], torch.zeros(1, H, 3) + fill_top)
    assert torch.equal(halos[2][1], torch.zeros(1, H, 3) + fill_bot)
    masks = [torch.ones((1, 2 * H, 2), dtype=torch.bool)] * 2
    top, bot = tiles._exchange_halos(masks)[0]
    assert top.dtype == torch.bool and not top.any() and bot.all()


def test_tiled_solve_agrees_with_jax():
    """The port's tiled solve against the JAX package's
    tile_sharded_patchmatch on a 2-device mesh, same inputs and key, at
    the solve-level bars; the port's tiled solve equals its untiled one
    on these inputs, so this is also the untiled solve's agreement."""
    if jax is None:
        pytest.skip("needs JAX")
    images, cams, plane_z = jax_scene(n_views=4, width=64, height=48)
    jp = JaxParams(patch_size=7, max_iterations=1, ncc_backend="jnp")
    jin = jax_inputs(images[0], images[1:], cams[0], cams[1:], jp, pad_h=1,
                     pad_w=1)
    key = jax.random.key(0)
    jout = jax_tiled(jax_tile_mesh(devices=jax.devices()[:2]), jin, key, jp,
                     JaxMode())
    jdepth = np.asarray(jout.depth)
    tin, tkey = solver_inputs_from_numpy(jax.tree.map(np.asarray, jin),
                                         jax.random.key_data(key),
                                         device="cpu")
    tp = PatchMatchParams(patch_size=7, max_iterations=1)
    tout = tiles.tile_sharded_patchmatch(tiles.make_tile_mesh(devices=CPU2),
                                         tin, tkey, tp, Mode())
    assert torch.equal(tout.depth, run_patchmatch(tin, tkey, tp).depth)
    interior = np.s_[10:38, 12:52]
    rel = (np.abs(tout.depth.numpy()[interior] - jdepth[interior])
           / np.abs(jdepth[interior]))
    s1, s5 = (rel < 0.01).mean(), (rel < 0.05).mean()
    assert s1 >= SHARE_WITHIN_1PCT and s5 >= SHARE_WITHIN_5PCT, (s1, s5)
    assert np.median(np.abs(tout.depth.numpy()[interior] - plane_z)) < 0.15


@pytest.fixture(scope="module")
def geom_rig():
    """tests/test_torch_geom.py's non-round rig, taller (48 rows), with
    smooth source depth maps and two off-plane hypotheses."""
    if jax is None:
        pytest.skip("needs JAX")
    images, cams_, plane_z = jax_scene(n_views=3, width=128, height=48,
                                       f=151.73, plane_z=5.1703)
    jp = JaxParams(ncc_backend="jnp")
    jin = jax_inputs(images[0], images[1:], cams_[0], cams_[1:], jp)
    tin, _ = solver_inputs_from_numpy(jax.tree.map(np.asarray, jin),
                                      np.zeros(2, np.uint32), device="cpu")
    H, W = jin.ref_img.shape
    Hs, Ws = jin.src_imgs.shape[1:]
    gy = np.linspace(0.0, 0.3, Hs, dtype=np.float32)[:, None]
    depths = np.stack([np.full((Hs, Ws), plane_z, np.float32) + gy,
                       np.full((Hs, Ws), plane_z, np.float32) - gy])
    x, y = jgeo.pixel_grid(H, W)
    n_cam = jgeo.normal_world_to_cam(
        jin.ref_cam, jnp.broadcast_to(jnp.asarray([0.0, 0.0, -1.0]),
                                      x.shape + (3,)))
    planes = np.stack([np.asarray(jgeo.plane_from_depth_normal(
        jin.ref_cam, x, y, jnp.full(x.shape, plane_z * s), n_cam))
        for s in (1.031, 0.967)])
    return dict(jin=jin, tin=tin, jp=jp, depths=depths, planes=planes,
                x=np.asarray(x), y=np.asarray(y))


@pytest.mark.parametrize("off0", [None, 0, 1])
def test_geom_at_origin_matches_oracle(geom_rig, off0):
    """The plain cost of the rows [16, 40) as a tile at origin (16, 0),
    full and packed at both parities, against the JAX oracle on the same
    image-coordinate grid, at its bar (1e-4); and equal to the untiled
    cost of the same rows, bitwise."""
    r = geom_rig
    band = np.s_[:, 16:40]
    planes, x, y = r["planes"][band], r["x"][16:40], r["y"][16:40]
    if off0 is not None:
        planes = np.asarray(jparity.pack_rows_c(planes, off0))
        x = np.asarray(jparity.pack_rows(x, off0))
        y = np.asarray(jparity.pack_rows(y, off0))
    tin = r["tin"]
    got = tgeom.geom_consistency_cost(
        tin.ref_cam, tin.src_cams, torch.as_tensor(r["depths"]),
        torch.as_tensor(planes), PatchMatchParams(), row_pack_off=off0,
        origin=(16, 0)).numpy()
    jin = r["jin"]
    want = np.asarray(jax_geom(jin.ref_cam, jin.src_cams,
                               jnp.asarray(r["depths"]), jnp.asarray(planes),
                               jnp.asarray(x), jnp.asarray(y), r["jp"]))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert (got < PatchMatchParams().geom_cost_max).any()
    if off0 is None:
        whole = tgeom.geom_consistency_cost(
            tin.ref_cam, tin.src_cams, torch.as_tensor(r["depths"]),
            torch.as_tensor(r["planes"]), PatchMatchParams()).numpy()
        np.testing.assert_array_equal(got, whole[band])


@pytest.mark.cuda
def test_geom_kernel_at_origin_on_card():
    """geom.cu at a tile origin torch.equal to its plain version (K = 1
    full, K = 8 and 5 packed at both parities), and at (0, 0) to the
    kernel called without an origin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from acmmp_tpu_torch.ops import sampling

    dev = "cuda"
    images, cams_, plane_z = textured_plane_scene(
        n_views=4, width=128, height=64, f=151.73, plane_z=5.1703)
    inp = build_solver_inputs(images[0], images[1:], cams_[0], cams_[1:],
                              PatchMatchParams(), device=dev)
    V, Hs, Ws = inp.src_imgs.shape
    gy = torch.linspace(0.0, 0.3, Hs, device=dev)[:, None].expand(Hs, Ws)
    depths = torch.stack([plane_z + gy, plane_z - gy, plane_z + 0.5 * gy])
    H, W = 32, inp.ref_img.shape[1]
    x, y = tgeo.pixel_grid(H, W, device=dev)
    y = y + 24.0
    planes = torch.stack([sampling.random_plane(
        k, inp.ref_cam, x, y, inp.depth_min, inp.depth_max)
        for k in keys.split(keys.key(5), 8)])
    plain = PatchMatchParams(ncc_backend="plain")
    for origin in ((24, 0), (0, 0), (-24, 0)):
        for K, off0 in ((1, None), (8, 0), (8, 1), (5, 0), (5, 1)):
            pk = (planes[:K] if off0 is None
                  else tparity.pack_rows_c(planes[:K], off0)).contiguous()
            args = (inp.ref_cam, inp.src_cams, depths, pk)
            got = tgeom.geom_consistency_cost(*args, PatchMatchParams(),
                                              row_pack_off=off0,
                                              origin=origin)
            want = tgeom.geom_consistency_cost(*args, plain,
                                               row_pack_off=off0,
                                               origin=origin)
            assert torch.equal(got, want), (origin, K, off0)
            if origin == (0, 0):
                assert torch.equal(got, tgeom.geom_consistency_cost(
                    *args, PatchMatchParams(), row_pack_off=off0))
