"""Float sources (PatchMatchParams(ncc_src_u8=False)) in acmmp_tpu_torch's
ZNCC, on the CPU: the 128x32, 3-source scene of tests/test_pallas_ncc.py
with its real-valued pixels kept, shipping params otherwise.

The JAX Pallas kernels take float sources as bf16 words only to fit the
TPU's VMEM; the semantics of ncc_src_u8=False are float sampling, as the
jnp oracle computes them. So the port's kernel (csrc/zncc.cu, the float4
instantiation) reads f32 2x2 quads (ops/cuda_ncc.py::pack_2x2_f32), and
its plain version reads the floats. Here: the plain version against the
jnp oracle at the JAX package's ZNCC bar (fewer than 0.1% of costs off
by more than 2e-3 + 1e-3 |ref|), at K=1 on the full grid and K=8 packed;
the plain version on bf16-rounded pixels against the Pallas kernel with
force_bf16 in interpret mode, which shows the two read the same pixels
but for the TPU's storage type; pack_2x2_f32 against the four clamped
floats at every pixel of the padded array; prepare building the quads
once per solve, shared by both layouts, and no 8-bit words beside them;
and the port's plain photometric solve of the relief scene with float
sources at tests/test_relief.py's bars. The kernel runs only on a card:
the cuda-marked test holds it to the plain version at the ZNCC bar, K-
stacks bitwise to K=1 launches, the float4 instantiation bitwise to the
8-bit one on u8-valued floats and to csrc/ablate.cu's `first` on f32
sources (the kernel's first design). JAX is imported only where it is
installed, so that the card test also runs without it:
`python -m pytest --noconftest -m cuda tests/test_torch_float_sources.py`."""

import numpy as np
import pytest
import torch

from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.core import geometry as tgeo
from acmmp_tpu_torch.engine.inputs import (build_solver_inputs,
                                           solver_inputs_from_numpy)
from acmmp_tpu_torch.engine.patchmatch import Mode, run_patchmatch
from acmmp_tpu_torch.ops import cuda_ncc, keys
from acmmp_tpu_torch.ops import ncc as tncc
from acmmp_tpu_torch.ops import parity as tparity
from acmmp_tpu_torch.ops import sampling as tsamp
from acmmp_tpu_torch.utils.synth import (textured_plane_scene,
                                         textured_relief_scene)

try:
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from acmmp_tpu.config import PatchMatchParams as JaxParams
    from acmmp_tpu.core import geometry as jgeo
    from acmmp_tpu.engine.inputs import build_solver_inputs as jax_inputs
    from acmmp_tpu.ops import ncc as jncc
    from acmmp_tpu.ops import parity as jparity
    from acmmp_tpu.ops import sampling as jsamp
    from acmmp_tpu.ops.pallas_ncc import multiview_zncc_pallas

    from .util import textured_plane_scene as jax_plane_scene
except ImportError:      # a card machine without JAX: the card test only
    jax = None

torch.set_num_threads(1)

TF = PatchMatchParams(ncc_src_u8=False)
PLAIN_F = PatchMatchParams(ncc_src_u8=False, ncc_backend="plain")
# tests/test_relief.py's bars: median interior error, share under 0.2,
# correlation with the ground truth
RELIEF_MEDIAN, RELIEF_SHARE, RELIEF_CORR = 0.05, 0.85, 0.85


def _zncc_bar(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    bad = np.abs(got - want) > 2e-3 + 1e-3 * np.abs(want)
    assert bad.mean() < 1e-3, (
        f"{bad.mean():.5f} of costs differ; max |d|="
        f"{np.abs(got - want).max()}")


def _real_valued(src):
    """The share of source pixels that are not integers."""
    return float((src != torch.round(src)).float().mean())


@pytest.fixture(scope="module")
def scene():
    if jax is None:
        pytest.skip("needs JAX")
    jf = JaxParams(ncc_backend="jnp", ncc_src_u8=False)
    images, cams, plane_z = jax_plane_scene(n_views=3, width=128,
                                            height=32)
    # one padded view slot: n_views (2) < V (3)
    jin = jax_inputs(images[0], images[1:], cams[0], cams[1:], jf,
                     num_views_pad=3)
    tin, _ = solver_inputs_from_numpy(jax.tree.map(np.asarray, jin),
                                      np.zeros(2, np.uint32), device="cpu")
    assert _real_valued(tin.src_imgs[:2]) > 0.5
    H, W = jin.ref_img.shape
    x, y = jgeo.pixel_grid(H, W)
    n = jnp.broadcast_to(jnp.asarray([0.0, 0.0, -1.0]), x.shape + (3,))
    n_cam = jgeo.normal_world_to_cam(jin.ref_cam, n)
    coherent = [jgeo.plane_from_depth_normal(
        jin.ref_cam, x, y, jnp.full(x.shape, plane_z * (1.0 + 0.02 * (k - 4))),
        n_cam) for k in range(8)]
    rand = [jsamp.random_plane(k, jin.ref_cam, x, y, jin.depth_min,
                               jin.depth_max, tile_window=0.125,
                               min_cos=0.25)
            for k in jax.random.split(jax.random.key(3), 8)]
    return dict(jf=jf, jin=jin, tin=tin,
                jvg=jncc.make_view_geometry(jin.ref_cam, jin.src_cams),
                tvg=tncc.make_view_geometry(tin.ref_cam, tin.src_cams),
                coherent=np.array(jnp.stack(coherent)),
                random=np.array(jnp.stack(rand)))


@pytest.mark.parametrize("field,K,off0", [
    ("coherent", 1, None), ("random", 1, None), ("random", 8, 0),
    ("coherent", 8, 1)])
def test_plain_float_sources_match_jnp_oracle(scene, field, K, off0):
    s = scene
    jin, tin = s["jin"], s["tin"]
    planes = s[field][:K]
    if off0 is None:
        want = jax.jit(jncc.multiview_zncc, static_argnames=("params",))(
            jin.ref_img, jin.src_imgs, s["jvg"], planes, s["jf"])
        got = tncc.multiview_zncc(tin.ref_img, tin.src_imgs, s["tvg"],
                                  torch.as_tensor(planes), TF, n_views=2)
    else:
        packed = np.array(jparity.pack_rows_c(planes, jnp.int32(off0)))
        want = jax.jit(jncc.multiview_zncc_packed,
                       static_argnames=("params",))(
            jin.ref_img, jin.src_imgs, s["jvg"], packed, s["jf"],
            jnp.int32(off0))
        got = tncc.multiview_zncc_packed(
            tin.ref_img, tin.src_imgs, s["tvg"], torch.as_tensor(packed), TF,
            off0, n_views=2)
    # the padded slot is masked downstream in both packages
    _zncc_bar(got.numpy()[..., :2], np.asarray(want)[..., :2])


def test_plain_on_bf16_pixels_matches_pallas_force_bf16(scene):
    """The Pallas kernel stores float sources as bf16; fed the same
    bf16-rounded pixels, the port's plain version computes its costs."""
    s = scene
    jin, tin = s["jin"], s["tin"]
    planes = s["random"][:1]
    with pltpu.force_tpu_interpret_mode():
        want = multiview_zncc_pallas(jin.ref_img, jin.src_imgs, s["jvg"],
                                     jnp.asarray(planes), s["jf"],
                                     force_bf16=True, n_views=jnp.int32(2))
    src_bf16 = tin.src_imgs.to(torch.bfloat16).to(torch.float32)
    got = tncc.multiview_zncc(tin.ref_img, src_bf16, s["tvg"],
                              torch.as_tensor(planes), TF, n_views=2)
    _zncc_bar(got.numpy()[..., :2], np.asarray(want)[..., :2])


# (padded shape [V, Hs, Ws], true widths, true heights), as in
# tests/test_torch_zncc_layout.py
LAYOUTS = {
    "odd sizes": ((2, 7, 13), (13, 13), (7, 7)),
    "1xN": ((1, 1, 9), (9,), (1,)),
    "Nx1": ((1, 9, 1), (1,), (9,)),
    "views smaller than the padded array": ((3, 8, 16), (11, 16, 5),
                                            (6, 8, 3)),
}


def _pack_f32(src, widths, heights):
    return cuda_ncc.pack_2x2_f32(
        torch.as_tensor(src), torch.as_tensor(widths, dtype=torch.float32),
        torch.as_tensor(heights, dtype=torch.float32))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pack_2x2_f32_holds_the_four_clamped_floats(layout):
    shape, widths, heights = LAYOUTS[layout]
    rng = np.random.default_rng(5)
    src = rng.uniform(0.0, 255.0, shape).astype(np.float32)
    got = _pack_f32(src, widths, heights)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape + (4,)
    assert got.is_contiguous()
    q = got.numpy()
    V, Hs, Ws = shape
    for v, (w, h) in enumerate(zip(widths, heights)):
        # every quad, past the true extent too: the far side is clamped to
        # the view's last column and row
        for y in range(Hs):
            for x in range(Ws):
                x1, y1 = min(x + 1, w - 1), min(y + 1, h - 1)
                want = (src[v, y, x], src[v, y, x1], src[v, y1, x],
                        src[v, y1, x1])
                assert tuple(q[v, y, x]) == want, (layout, v, y, x)
    # on u8-valued floats the quads hold pack_2x2's bytes
    u8 = rng.integers(0, 256, shape, dtype=np.uint8)
    words = cuda_ncc.pack_2x2(
        torch.as_tensor(u8), torch.as_tensor(widths, dtype=torch.float32),
        torch.as_tensor(heights, dtype=torch.float32)).numpy().view(np.uint32)
    quads = _pack_f32(u8.astype(np.float32), widths, heights).numpy()
    for n in range(4):
        np.testing.assert_array_equal(quads[..., n],
                                      ((words >> (8 * n)) & 0xFF))


def _plane_inputs(params, device, num_views_pad=None):
    images, cams, _ = textured_plane_scene(n_views=4, width=128, height=32)
    return build_solver_inputs(images[0], images[1:], cams[0], cams[1:],
                               params, num_views_pad=num_views_pad,
                               device=device)


def test_prepare_builds_the_quads_once_per_solve():
    inp = _plane_inputs(TF, "cpu", num_views_pad=4)
    assert _real_valued(inp.src_imgs[:3]) > 0.5
    vg = tncc.make_view_geometry(inp.ref_cam, inp.src_cams)
    full = cuda_ncc.prepare(inp.ref_img, inp.src_imgs, vg, TF)
    packed = cuda_ncc.prepare(inp.ref_img, inp.src_imgs, vg, TF, 1,
                              shared=full)
    assert full.src_type == packed.src_type == "f32"
    # a float prep holds the quads and no 8-bit sources
    assert full.src_u8 is None and full.src_q is None
    for name in ("src_f4", "consts", "taps"):
        assert getattr(packed, name) is getattr(full, name), name
    assert torch.equal(full.src_f4, cuda_ncc.pack_2x2_f32(
        inp.src_imgs, vg.src_width, vg.src_height))
    alone = cuda_ncc.prepare(inp.ref_img, inp.src_imgs, vg, TF, 1)
    for a, b in zip(packed, alone):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b
    # and an 8-bit prep no quads; the two do not mix
    u8 = cuda_ncc.prepare(inp.ref_img, inp.src_imgs, vg, PatchMatchParams())
    assert u8.src_type == "u8" and u8.src_f4 is None
    with pytest.raises(ValueError, match="f32 sources"):
        cuda_ncc.prepare(inp.ref_img, inp.src_imgs, vg, PatchMatchParams(),
                         1, shared=full)


def test_plain_float_source_solve_recovers_relief():
    """The port's photometric solve with float sources on the relief
    scene, at tests/test_relief.py's bars. The JAX package measures a
    correlation of 0.92 there with float sources (tests/test_relief.py);
    the port's plain version, key 0 on the CPU: 0.9231 (median error
    0.0181, 0.9605 under 0.2), against 0.8863 (0.0458, 0.8978) with 8-bit
    sources."""
    params = PatchMatchParams(patch_size=7, ncc_src_u8=False)
    images, cams, gt = textured_relief_scene(n_views=4)
    inputs = build_solver_inputs(images[0], images[1:], cams[0], cams[1:],
                                 params, pad_h=1, pad_w=1, device="cpu")
    assert _real_valued(inputs.src_imgs) > 0.5
    out = run_patchmatch(inputs, keys.key(0), params, Mode())
    depth = out.depth.numpy()
    H, W = gt.shape
    interior = np.s_[8:H - 8, 10:W - 10]
    err = np.abs(depth[:H, :W][interior] - gt[interior])
    assert np.median(err) < RELIEF_MEDIAN, np.median(err)
    assert (err < 0.2).mean() > RELIEF_SHARE, (err < 0.2).mean()
    corr = np.corrcoef(depth[:H, :W][interior].ravel(),
                       gt[interior].ravel())[0, 1]
    assert corr > RELIEF_CORR, corr


@pytest.mark.cuda
def test_float_source_kernel_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from acmmp_tpu_torch.ops import cuda_ablate

    dev = "cuda"
    u8_params = PatchMatchParams()
    for label, build in (("real-valued", TF), ("u8-valued", u8_params)):
        # 3 sources and a padded view slot
        inp = _plane_inputs(build, dev, num_views_pad=4)
        assert (_real_valued(inp.src_imgs[:3]) > 0.5) == (build is TF)
        vg = tncc.make_view_geometry(inp.ref_cam, inp.src_cams)
        H, W = inp.ref_img.shape
        x, y = tgeo.pixel_grid(H, W, device=dev)
        planes = torch.stack([tsamp.random_plane(
            k, inp.ref_cam, x, y, inp.depth_min, inp.depth_max,
            tile_window=0.125, min_cos=0.25)
            for k in keys.split(keys.key(3), 8)])
        for K, off0 in ((1, None), (8, 0), (3, 1), (2, 0)):
            pk = (planes[:K] if off0 is None
                  else tparity.pack_rows_c(planes[:K], off0)).contiguous()

            def run(params, hyps):
                if off0 is None:
                    return tncc.multiview_zncc(inp.ref_img, inp.src_imgs, vg,
                                               hyps, params, n_views=3)
                return tncc.multiview_zncc_packed(
                    inp.ref_img, inp.src_imgs, vg, hyps, params, off0,
                    n_views=3)

            before = dict(cuda_ncc.launches_f32)
            got = run(TF, pk)
            assert cuda_ncc.launches_f32[K] == before[K] + 1
            want = run(PLAIN_F, pk)
            _zncc_bar(got[..., :3].cpu(), want[..., :3].cpu())
            assert bool((got[..., 3] == TF.cost_max).all()), (label, K)
            singles = [run(TF, pk[k:k + 1].contiguous()) for k in range(K)]
            assert torch.equal(torch.cat(singles), got), (label, K)
            if build is u8_params:
                # a byte becomes f32 exactly: the same rounded values
                assert torch.equal(got, run(u8_params, pk)), (label, K)
            if K == 8:
                # the first design on the same f32 sources
                zp = cuda_ncc.prepare(inp.ref_img, inp.src_imgs, vg, TF,
                                      off0)
                aprep = cuda_ablate.AblatePrep(
                    zp, inp.src_imgs.contiguous(), None)
                assert torch.equal(got, cuda_ablate.ablate_cuda(
                    "first", pk, aprep, TF, 3)), label
        assert float(got.min()) < TF.cost_max     # informative costs
