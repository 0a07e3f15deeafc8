"""acmmp_tpu_torch's projection geometry and plain geometric-consistency
cost against acmmp_tpu on the same inputs (CPU).

The rig is the non-round one of tests/test_pallas_geom.py (f = 151.73,
plane at z = 5.1703, 128x32): with round numbers the true plane projects
pixels to integer source coordinates, a truncation knife-edge everywhere.
Hypotheses sit off the true plane by x1.031 and x0.967; the depth maps are
a smooth gradient, one with a zeroed band of rows, and one padded view
slot of zeros. The plain cost is held to the JAX package's bar for its
oracle (1e-4, tests/test_pallas_geom.py:126) on the full grid and packed
at both parities, and once to its bar for the Pallas kernel in interpret
mode (fewer than 2e-3 of costs beyond 1e-3 + 1e-3 |b|). Both staged f32
evaluations agree but for rounding (XLA:CPU fuses multiply-adds), so the
geom_cost_max validity bands match exactly away from the band's
knife-edge rows. The CUDA kernel runs only on a card: the cuda-marked
test holds it bitwise to this plain version and to its first design
there, and chip_smoke.py at the main paths' shapes. JAX is imported only
where it is installed, so that the card test also runs without it:
`python -m pytest --noconftest -m cuda tests/test_torch_geom.py`."""

import numpy as np
import pytest
import torch

from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.core import geometry as tgeo
from acmmp_tpu_torch.engine.inputs import solver_inputs_from_numpy
from acmmp_tpu_torch.ops import cuda_geom
from acmmp_tpu_torch.ops import geom as tgeom
from acmmp_tpu_torch.ops import parity as tparity

try:
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from acmmp_tpu.config import PatchMatchParams as JaxParams
    from acmmp_tpu.core import geometry as jgeo
    from acmmp_tpu.engine.inputs import build_solver_inputs
    from acmmp_tpu.ops import parity as jparity
    from acmmp_tpu.ops.geom import geom_consistency_cost as jax_geom
    from acmmp_tpu.ops.pallas_geom import geom_consistency_cost_pallas

    from .util import textured_plane_scene

    JP = JaxParams(ncc_backend="jnp")
except ImportError:      # a card machine without JAX: the card test only
    jax = None

torch.set_num_threads(1)

TP = PatchMatchParams()
MAX = TP.geom_cost_max


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def rig():
    if jax is None:
        pytest.skip("needs JAX")
    images, cams, plane_z = textured_plane_scene(
        n_views=3, width=128, height=32, f=151.73, plane_z=5.1703)
    # two real sources and one padded view slot (zero depth map)
    jin = build_solver_inputs(images[0], images[1:], cams[0], cams[1:], JP,
                              num_views_pad=3)
    tin, _ = solver_inputs_from_numpy(jax.tree.map(np.asarray, jin),
                                      np.zeros(2, np.uint32), device="cpu")
    H, W = jin.ref_img.shape
    x, y = jgeo.pixel_grid(H, W)
    Hs, Ws = jin.src_imgs.shape[1:]
    gy = np.linspace(0.0, 0.3, Hs, dtype=np.float32)[:, None]
    smooth = np.stack([np.full((Hs, Ws), plane_z, np.float32) + gy,
                       np.full((Hs, Ws), plane_z, np.float32) - gy,
                       np.zeros((Hs, Ws), np.float32)])
    band = smooth.copy()
    band[0, :4] = 0.0
    band[1, :4] = 0.0
    n = jnp.broadcast_to(jnp.asarray([0.0, 0.0, -1.0]), x.shape + (3,))
    n_cam = jgeo.normal_world_to_cam(jin.ref_cam, n)
    planes = np.stack([np.asarray(jgeo.plane_from_depth_normal(
        jin.ref_cam, x, y, jnp.full(x.shape, plane_z * s), n_cam))
        for s in (1.031, 0.967)])
    return dict(jin=jin, tin=tin, x=np.asarray(x), y=np.asarray(y),
                smooth=smooth, band=band, planes=planes)


@pytest.fixture(scope="module")
def cams():
    """A randomly oriented reference camera and three sources turned and
    moved slightly from it, so the test points lie in front of all four."""
    if jax is None:
        pytest.skip("needs JAX")
    rng = np.random.default_rng(0)
    q, _r = np.linalg.qr(rng.normal(size=(3, 3)))
    R0 = q * np.sign(np.linalg.det(q))
    C0 = rng.normal(size=3)
    out = []
    for v in range(4):
        a = rng.uniform(-0.15, 0.15, size=3) if v else np.zeros(3)
        Rx = np.array([[1, 0, 0], [0, np.cos(a[0]), -np.sin(a[0])],
                       [0, np.sin(a[0]), np.cos(a[0])]])
        Ry = np.array([[np.cos(a[1]), 0, np.sin(a[1])], [0, 1, 0],
                       [-np.sin(a[1]), 0, np.cos(a[1])]])
        R = (Rx @ Ry @ R0).astype(np.float32)
        C = C0 + (rng.normal(size=3) * 0.3 if v else 0.0)
        t = (-R @ C).astype(np.float32)
        f = rng.uniform(80, 200)
        K = np.array([[f, 0, 31.5 + rng.uniform(-3, 3)],
                      [0, f * rng.uniform(0.95, 1.05),
                       23.5 + rng.uniform(-3, 3)], [0, 0, 1]], np.float32)
        out.append((K, R, t, 64.0, 48.0, 1.0, 20.0))
    jref, tref = (jgeo.Camera.from_numpy(*out[0]),
                  tgeo.Camera.from_numpy(*out[0]))
    jsrc = jgeo.stack_cameras([jgeo.Camera.from_numpy(*c) for c in out[1:]])
    tsrc = tgeo.stack_cameras([tgeo.Camera.from_numpy(*c) for c in out[1:]])
    return dict(jref=jref, tref=tref, jsrc=jsrc, tsrc=tsrc)


@pytest.mark.parametrize("fn", ["cam_to_world", "world_point", "project",
                                "nearest_sample"])
def test_projection_geometry_matches_jnp(cams, fn):
    c = cams
    rng = np.random.default_rng(1)
    x, y = np.meshgrid(np.arange(64, dtype=np.float32),
                       np.arange(48, dtype=np.float32))
    d = rng.uniform(2, 10, size=x.shape).astype(np.float32)
    X = np.asarray(jgeo.world_point(c["jref"], x, y, d))
    close = lambda a, b: np.testing.assert_allclose(   # noqa: E731
        np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5)
    if fn == "cam_to_world":
        close(tgeo.cam_to_world(c["tref"], _t(X)),
              jgeo.cam_to_world(c["jref"], X))
    elif fn == "world_point":
        close(tgeo.world_point(c["tref"], _t(x), _t(y), _t(d)),
              jgeo.world_point(c["jref"], x, y, d))
    elif fn == "project":
        # a stacked source camera against a trailing view axis, as the
        # geom cost uses it
        tuv, tz = tgeo.project(c["tsrc"], _t(X)[..., None, :])
        juv, jz = jax.vmap(lambda s: jgeo.project(s, X),
                           out_axes=(-2, -1))(c["jsrc"])
        close(tuv, juv)
        close(tz, jz)
    else:
        img = rng.uniform(0, 9, size=(48, 64)).astype(np.float32)
        sx = rng.uniform(-5, 70, size=x.shape).astype(np.float32)
        sy = rng.uniform(-5, 55, size=x.shape).astype(np.float32)
        got = tgeo.nearest_sample(_t(img), _t(sx), _t(sy), 60.0, 45.0)
        want = jgeo.nearest_sample(jnp.asarray(img), sx, sy, 60.0, 45.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _oracle(r, depths, planes, x, y):
    jin = r["jin"]
    return np.asarray(jax_geom(jin.ref_cam, jin.src_cams, jnp.asarray(depths),
                               jnp.asarray(planes), jnp.asarray(x),
                               jnp.asarray(y), JP))


def _plain(r, depths, planes, off0=None):
    tin = r["tin"]
    return tgeom.geom_consistency_cost(
        tin.ref_cam, tin.src_cams, _t(depths), _t(planes), TP,
        row_pack_off=off0).numpy()


@pytest.mark.parametrize("case", ["full", "packed0", "packed1", "band"])
def test_plain_matches_oracle(rig, case):
    r = rig
    depths = r["band"] if case == "band" else r["smooth"]
    x, y, planes = r["x"], r["y"], r["planes"]
    off0 = None
    if case.startswith("packed"):
        off0 = int(case[-1])
        pk = lambda a: np.asarray(jparity.pack_rows(a, off0))  # noqa: E731
        planes = np.asarray(jparity.pack_rows_c(planes, off0))
        x, y = pk(x), pk(y)
    got = _plain(r, depths, planes, off0)
    want = _oracle(r, depths, planes, x, y)
    assert got.shape == planes.shape[:3] + (3,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the padded view slot (zero depths) is at the maximum
    assert (got[..., 2] == MAX).all()
    if case == "band":
        assert (got[..., :2] >= MAX).any()
        # away from the knife-edge rows both agree exactly on validity
        np.testing.assert_array_equal(got[:, 10:] >= MAX,
                                      want[:, 10:] >= MAX)


def test_plain_matches_pallas_interpret(rig):
    r = rig
    off0 = 1
    planes = np.asarray(jparity.pack_rows_c(r["planes"], off0))
    got = _plain(r, r["band"], planes, off0)
    jin = r["jin"]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(geom_consistency_cost_pallas(
            jin.ref_cam, jin.src_cams, jnp.asarray(r["band"]),
            jnp.asarray(planes), JP, row_pack_off=off0))
    bad = np.abs(got - want) > 1e-3 + 1e-3 * np.abs(want)
    assert bad.mean() < 2e-3, (bad.mean(), np.abs(got - want).max())
    np.testing.assert_array_equal(got[:, 5:] >= MAX, want[:, 5:] >= MAX)


def test_packed_plain_equals_packed_full(rig):
    """The geom cost is pointwise: the packed evaluation is the packed rows
    of the full one, bitwise."""
    r = rig
    full = _plain(r, r["smooth"], r["planes"])
    for off0 in (0, 1):
        got = _plain(r, r["smooth"],
                     tparity.pack_rows_c(_t(r["planes"]), off0), off0)
        np.testing.assert_array_equal(
            got, tparity.pack_rows_c(_t(full), off0).numpy())


def test_cuda_wrapper_raises_on_cpu_tensors(rig):
    tin = rig["tin"]
    planes = _t(rig["planes"])
    args = (tin.ref_cam, tin.src_cams, _t(rig["smooth"]))
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        cuda_geom.geom_consistency_cost_cuda(*args, planes, TP)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        tgeom.geom_consistency_cost(*args, planes,
                                    PatchMatchParams(ncc_backend="cuda"))
    # "auto" on CPU tensors is the plain version, and counts no launch
    before = cuda_geom.total_launches()
    out = tgeom.geom_consistency_cost(*args, planes, TP)
    assert out.shape == planes.shape[:3] + (3,)
    assert cuda_geom.total_launches() == before


@pytest.mark.cuda
@pytest.mark.parametrize("n_src,v_pad", [(2, 3), (3, 4)])
def test_kernel_matches_plain_on_card(n_src, v_pad):
    """The kernel bitwise equal to the plain version and to its first
    design, on the card: the rig above built by the port alone (2 sources
    in 3 view slots, the kernel's one-store-per-view path, and 3 in 4, its
    16-byte stores), smooth and banded depth maps, the two off-plane
    hypotheses and random ones, at K=1 on the full grid and K=8 and K=5
    packed at both parities."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from acmmp_tpu_torch.engine.inputs import build_solver_inputs as inputs
    from acmmp_tpu_torch.ops import keys, sampling
    from acmmp_tpu_torch.utils.synth import textured_plane_scene as scene

    dev = "cuda"
    images, cams_, plane_z = scene(n_views=n_src + 1, width=128, height=32,
                                   f=151.73, plane_z=5.1703)
    inp = inputs(images[0], images[1:], cams_[0], cams_[1:], TP,
                 num_views_pad=v_pad, device=dev)
    V, Hs, Ws = inp.src_imgs.shape
    H, W = inp.ref_img.shape
    gy = torch.linspace(0.0, 0.3, Hs, device=dev)[:, None].expand(Hs, Ws)
    smooth = torch.zeros((V, Hs, Ws), device=dev)
    for v in range(n_src):
        smooth[v] = plane_z + (gy if v % 2 == 0 else -gy)
    band = smooth.clone()
    band[:n_src, :4] = 0.0
    x, y = tgeo.pixel_grid(H, W, device=dev)
    n_cam = tgeo.normal_world_to_cam(
        inp.ref_cam, torch.tensor([0.0, 0.0, -1.0], device=dev).expand(
            H, W, 3))
    planes = torch.stack(
        [tgeo.plane_from_depth_normal(
            inp.ref_cam, x, y, torch.full((H, W), plane_z * s, device=dev),
            n_cam) for s in (1.031, 0.967)]
        + [sampling.random_plane(k, inp.ref_cam, x, y, inp.depth_min,
                                 inp.depth_max, tile_window=0.125,
                                 min_cos=0.25)
           for k in keys.split(keys.key(61), 6)])
    plain = PatchMatchParams(ncc_backend="plain")
    for depths in (smooth, band):
        for K, off0 in ((1, None), (8, 0), (8, 1), (5, 0), (5, 1)):
            pk = (planes[:K] if off0 is None
                  else tparity.pack_rows_c(planes[:K], off0)).contiguous()
            args = (inp.ref_cam, inp.src_cams, depths, pk)
            before = dict(cuda_geom.launches)
            got = tgeom.geom_consistency_cost(*args, TP, row_pack_off=off0,
                                              n_views=n_src)
            assert cuda_geom.launches[K] == before[K] + 1
            want = tgeom.geom_consistency_cost(*args, plain,
                                               row_pack_off=off0)
            first = cuda_geom.geom_first_cuda(*args, TP, row_pack_off=off0,
                                              n_views=n_src)
            assert torch.equal(got, want), (K, off0)
            assert torch.equal(got, first), (K, off0)
            assert bool((got[..., n_src:] == TP.geom_cost_max).all())
            # informative costs, and the band's invalid ones
            assert float(got[..., :n_src].min()) < TP.geom_cost_max
