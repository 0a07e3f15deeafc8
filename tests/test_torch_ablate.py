"""acmmp_tpu_torch's ZNCC cost-decomposition tool (tools/prop_ablate.py,
ops/ablate.py) against the JAX package's tools/prop_ablate.py on the CPU,
at the size of tests/test_pallas_ncc.py (128x32, 2 sources).

The relief scene is bitwise equal to the JAX one, and the port's
build_fields matches the JAX tool's (off0 equal, packed candidates within
1e-5 (1 + |x|)). The JAX tool's Pallas ablate_call takes about a minute
in interpret mode even at this size, so the plain `full` is held to the
jnp oracle of the same K-stack function instead, fed the JAX tool's own
packed candidates, at the ZNCC bar of tests/test_pallas_ncc.py (fewer
than 0.1% of costs off by more than 2e-3 + 1e-3 |ref|). `f32take` is
bitwise `full`; `noscan` is cost_max up to its 1e-30 leak; `noext` and
`nobounds` equal a direct numpy evaluation of their definitions. Under ops/ablate.EXPOSING, `noext`'s costs rest on its sums
and `noscan`'s are its leak, so that a comparison there would catch a
wrong sum. The kernel itself runs only on a card: the cuda-marked test,
and chip_smoke.py phase 9, hold each mode against its plain version
there; JAX is imported only where it is installed, so that the card
test also runs without it:
`python -m pytest --noconftest -m cuda tests/test_torch_ablate.py`."""

import importlib.util
import json
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.core import geometry as tgeo
from acmmp_tpu_torch.engine.inputs import solver_inputs_from_numpy
from acmmp_tpu_torch.ops import ablate, cuda_ablate
from acmmp_tpu_torch.ops import ncc as tncc
from acmmp_tpu_torch.tools import prop_ablate
from acmmp_tpu_torch.utils import synth as tsynth

try:
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from acmmp_tpu.config import PatchMatchParams as JaxParams
    from acmmp_tpu.ops import ncc as jncc
    from acmmp_tpu.utils import synth as jsynth
except ImportError:      # a card machine without JAX: the card test only
    jax = None

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
TP = PatchMatchParams()
HEIGHT, WIDTH, VIEWS = 32, 128, 2


def _zncc_bar(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    bad = np.abs(got - want) > 2e-3 + 1e-3 * np.abs(want)
    assert bad.mean() < 1e-3, (
        f"{bad.mean():.5f} of costs differ; max |d|="
        f"{np.abs(got - want).max()}")


def _load_jax_tool():
    """tools/prop_ablate.py as a module. Loading it sets the JAX
    compilation cache (prop_ablate.py:45-46) and sys.path; both are put
    back, so the suite keeps running without a persistent cache."""
    spec = importlib.util.spec_from_file_location(
        "_jax_prop_ablate", REPO / "tools" / "prop_ablate.py")
    mod = importlib.util.module_from_spec(spec)
    cache_dir = jax.config.jax_compilation_cache_dir
    min_secs = jax.config.jax_persistent_cache_min_compile_time_secs
    path = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          min_secs)
        sys.path[:] = path
    return mod


@pytest.fixture(scope="module")
def jax_tool():
    return _load_jax_tool()


@pytest.fixture(scope="module")
def fields(jax_tool):
    """Both tools' fields at 128x32 / 2 sources, and the port's inputs
    carried across from the JAX ones."""
    args = types.SimpleNamespace(height=HEIGHT, width=WIDTH, views=VIEWS)
    jparams, jin, jvg, jcand, joff0 = jax_tool.build_fields(args)
    tfields = prop_ablate.build_fields(HEIGHT, WIDTH, VIEWS, device="cpu")
    tin, _ = solver_inputs_from_numpy(jax.tree.map(np.asarray, jin),
                                      np.zeros(2, np.uint32), device="cpu")
    return dict(jin=jin, jvg=jvg, jcand=np.array(jcand),
                joff0=int(joff0), tfields=tfields, tin=tin,
                tvg=tncc.make_view_geometry(tin.ref_cam, tin.src_cams))


@pytest.mark.parametrize("kwargs", [
    dict(n_views=3, width=128, height=32, f=140.0 * 128 / 96.0, spread=1.2,
         converge=True),
    dict(n_views=4, width=96, height=64, seed=3)])
def test_relief_scene_bitwise(kwargs):
    ji, jc, jgt = jsynth.textured_relief_scene(**kwargs)
    ti, tc, tgt = tsynth.textured_relief_scene(**kwargs)
    for a, b in zip(ji, ti):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jc, tc):
        for f in ("K", "R", "t"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.depth_min, a.depth_max, a.width, a.height) == (
            b.depth_min, b.depth_max, b.width, b.height)
    np.testing.assert_array_equal(jgt, tgt)


def test_gradient_first_order_edges():
    """torch.gradient and jnp.gradient both take one-sided first-order
    differences at the edges and central ones inside."""
    a = np.random.default_rng(0).normal(size=(6, 9)).astype(np.float32)
    for axis in (0, 1):
        got = torch.gradient(torch.as_tensor(a), dim=axis)[0].numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jnp.gradient(jnp.asarray(a), axis=axis)))
        edge = np.take(a, 1, axis) - np.take(a, 0, axis)
        np.testing.assert_array_equal(np.take(got, 0, axis), edge)


def test_build_fields_matches_jax(fields):
    _, tin, _, tcand, toff0 = fields["tfields"]
    assert toff0 == fields["joff0"]
    assert tuple(tcand.shape) == fields["jcand"].shape == (
        8, HEIGHT // 2, WIDTH, 4)
    np.testing.assert_allclose(tcand.numpy(), fields["jcand"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tin.src_imgs.numpy(),
                                  np.asarray(fields["jin"].src_imgs))


def test_jax_nan_take_probe_interpret(jax_tool):
    with pltpu.force_tpu_interpret_mode():
        assert jax_tool.nan_take_probe()
    assert prop_ablate.nan_take_probe("cpu")


def _plain(mode, fields):
    tin = fields["tin"]
    return ablate.ablate_packed(mode, tin.ref_img, tin.src_imgs,
                                fields["tvg"],
                                torch.as_tensor(fields["jcand"]), TP,
                                fields["joff0"])


def test_plain_full_matches_jnp_oracle(fields):
    jin = fields["jin"]
    oracle = jax.jit(jncc.multiview_zncc_packed, static_argnames=("params",))
    want = oracle(jin.ref_img, jin.src_imgs, fields["jvg"], fields["jcand"],
                  JaxParams(ncc_backend="jnp"), jnp.int32(fields["joff0"]))
    got = _plain("full", fields)
    assert tuple(got.shape) == (8, HEIGHT // 2, WIDTH, VIEWS)
    _zncc_bar(got.numpy(), np.asarray(want))


def test_plain_f32take_is_full(fields):
    assert torch.equal(_plain("f32take", fields), _plain("full", fields))


def test_plain_noscan_is_cost_max_up_to_the_leak(fields):
    got = _plain("noscan", fields)
    # the leak is 1e-30 times an unsigned 32-bit sum: below f32's
    # resolution at cost_max, so the costs are cost_max exactly
    assert bool((got == TP.cost_max).all())
    tin = fields["tin"]
    _, _, leak = ablate.source_sums(
        "noscan", tin.ref_img, tin.src_imgs, fields["tvg"],
        torch.as_tensor(fields["jcand"]), TP, fields["joff0"])
    assert bool((leak > 0).all()) and bool((leak < 1e-30 * 2 ** 32).all())


def _pack(a, off0):
    """ops/parity.pack_rows in numpy: [H, W, ...] -> [H // 2, W, ...]."""
    H, W = a.shape[:2]
    a = a.reshape((H // 2, 2, W) + a.shape[2:])
    first = ((off0 + np.arange(W)) % 2 == 0).reshape(
        (1, W) + (1,) * (a.ndim - 3))
    return np.where(first, a[:, 0], a[:, 1])


def _direct(mode, fields):
    """The mode's definition evaluated directly in float64 numpy, from the
    port's f32 warp (the placement both versions share): the costs, and
    the unweighted-sum accumulator s_src for noext."""
    tin, tvg, off0 = fields["tin"], fields["tvg"], fields["joff0"]
    planes = torch.as_tensor(fields["jcand"])
    ref = tin.ref_img.numpy().astype(np.float64)
    src = tin.src_imgs.numpy().astype(np.float64)
    H, W = ref.shape
    V = src.shape[0]
    x, y = tgeo.pixel_grid(H, W)
    warp = tncc.warper(torch.as_tensor(_pack(x.numpy(), off0)),
                       torch.as_tensor(_pack(y.numpy(), off0)), tvg, planes)
    sw = tvg.src_width.numpy().astype(np.float64)
    sh = tvg.src_height.numpy().astype(np.float64)
    xi_max, yi_max = (sw - 1).astype(np.int64), (sh - 1).astype(np.int64)
    vv = np.arange(V)

    def place(di, dj):
        sx, sy = (np.nan_to_num(t.numpy().astype(np.float64), nan=0.0)
                  for t in warp(float(di), float(dj)))
        sx = np.minimum(np.maximum(sx, 0.0), sw - 1)
        sy = np.minimum(np.maximum(sy, 0.0), sh - 1)
        return (np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64),
                sx - np.floor(sx), sy - np.floor(sy))

    def corners(x0, y0):
        x1, y1 = np.minimum(x0 + 1, xi_max), np.minimum(y0 + 1, yi_max)
        return (src[vv, y0, x0], src[vv, y0, x1], src[vv, y1, x0],
                src[vv, y1, x1])

    def bilinear(x0, y0, fx, fy):
        v00, v01, v10, v11 = corners(x0, y0)
        return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
                + v10 * (1 - fx) * fy + v11 * fx * fy)

    cx, cy = (t.numpy() for t in warp(0.0, 0.0))
    in_bounds = (cx >= 0) & (cx < sw) & (cy >= 0) & (cy < sh)
    c_src = bilinear(*place(0, 0))
    taps = tncc.tap_weights_spatial(TP)
    di0, dj0, _ = taps[0]
    x00, y00, fx0, fy0 = place(di0, dj0)
    rows, cols = np.arange(H), np.arange(W)
    s = dict(w=0.0, ref=0.0, ref2=0.0, src=0.0, src2=0.0, rs=0.0)
    for di, dj, w_spatial in taps:
        tap = ref[np.clip(rows + dj, 0, H - 1)][:, np.clip(cols + di, 0,
                                                           W - 1)]
        ref_c = _pack(tap - ref, off0)[..., None]
        w = w_spatial * np.exp(-np.abs(ref_c) / (2 * TP.sigma_color ** 2))
        s["w"] += w
        s["ref"] += w * ref_c
        s["ref2"] += w * ref_c * ref_c
        if mode == "noext":
            s["src"] += w * sum(corners(*place(di, dj)[:2]))
            continue
        x0 = np.clip(x00 + (di - di0), 0, xi_max)
        y0 = np.clip(y00 + (dj - dj0), 0, yi_max)
        val = bilinear(x0, y0, fx0, fy0) - c_src
        s["src"] += w * val
        s["src2"] += w * val * val
        s["rs"] += w * ref_c * val
    if mode == "noext":
        s["src2"] = c_src
    mean_ref, mean_src = s["ref"] / s["w"], s["src"] / s["w"]
    var_ref = s["ref2"] / s["w"] - mean_ref ** 2
    var_src = s["src2"] / s["w"] - mean_src ** 2
    covar = s["rs"] / s["w"] - mean_ref * mean_src
    ncc = np.clip(1 - covar / np.sqrt(np.maximum(var_ref * var_src, 1e-30)),
                  0.0, TP.cost_max)
    bad = (var_ref < TP.min_var) | (var_src < TP.min_var) | ~in_bounds
    return np.where(bad, TP.cost_max, ncc), s["src"]


def test_plain_noext_matches_definition(fields):
    want, s_src = _direct("noext", fields)
    tin = fields["tin"]
    sums, _, _ = ablate.source_sums(
        "noext", tin.ref_img, tin.src_imgs, fields["tvg"],
        torch.as_tensor(fields["jcand"]), TP, fields["joff0"])
    np.testing.assert_allclose(sums[3].numpy(), s_src, rtol=1e-5, atol=1e-5)
    assert s_src.min() > 0
    np.testing.assert_array_equal(_plain("noext", fields).numpy(),
                                  want.astype(np.float32))


def test_plain_nobounds_matches_definition(fields):
    want, _ = _direct("nobounds", fields)
    got = _plain("nobounds", fields).numpy()
    # a scored cost, not only cost_max, on most pixels
    assert (want < TP.cost_max).mean() > 0.5
    _zncc_bar(got, want)
    # it reads other pixels than full does
    assert not np.allclose(got, _plain("full", fields).numpy())


def test_exposing_params_make_noext_rest_on_its_sums(fields):
    tin, tvg = fields["tin"], fields["tvg"]
    planes = torch.as_tensor(fields["jcand"])
    xp = ablate.exposing_params("noext", TP)
    assert xp.min_var == -np.inf and xp.cost_max == np.inf
    got = ablate.ablate_packed("noext", tin.ref_img, tin.src_imgs, tvg,
                               planes, xp, fields["joff0"])
    # at the shipped params every cost is cost_max, whatever s_src is
    assert bool((_plain("noext", fields) == TP.cost_max).all())
    within, info, worst = ablate.exposed_agreement(got, got)
    assert (within, worst) == (1.0, 0.0)
    assert info > 0.2
    # a kernel whose s_src were 1e-4 off would fail the chip's bar (0.99
    # of the informative costs within 1e-5, relative), as would one that
    # dropped one tap's reads
    sums, in_bounds, _ = ablate.source_sums(
        "noext", tin.ref_img, tin.src_imgs, tvg, planes, TP,
        fields["joff0"])
    assert torch.equal(tncc.zncc_from_sums(*sums, in_bounds, xp), got)
    for s_src in (sums[3] * (1 + 1e-4), sums[3] - sums[3] / 36):
        off = tncc.zncc_from_sums(*sums[:3], s_src, *sums[4:], in_bounds,
                                  xp)
        assert ablate.exposed_agreement(off, got)[0] < 0.5


def test_exposing_params_make_noscan_its_leak(fields):
    tin = fields["tin"]
    planes = torch.as_tensor(fields["jcand"])
    xp = ablate.exposing_params("noscan", TP)
    got = ablate.ablate_packed("noscan", tin.ref_img, tin.src_imgs,
                               fields["tvg"], planes, xp, fields["joff0"])
    _, _, leak = ablate.source_sums("noscan", tin.ref_img, tin.src_imgs,
                                    fields["tvg"], planes, TP,
                                    fields["joff0"])
    assert torch.equal(got, leak.expand_as(got))
    within, info, _ = ablate.exposed_agreement(got, got)
    assert within == 1.0 and info == 1.0
    # a kernel with one read a row off (128 offsets) in every (pixel,
    # view) fails the 1e-5 bar at this size, where the sums are below 1.3e7
    assert ablate.exposed_agreement(got + ablate.LEAK * WIDTH, got)[0] == 0.0


def test_tool_runs_on_cpu(capsys):
    assert prop_ablate.main(["--device", "cpu", "--height", "32", "--width",
                             "128", "--views", "2", "--reps", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["tool"] == "prop_ablate" and out["shape"] == "128x32"
    assert out["views"] == 2 and out["f32_take_bit_exact"] is True
    assert sorted(out["times_ms"]) == sorted(ablate.MODES)
    assert out["device"] == "cpu"


def test_tool_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        prop_ablate.main(["--height", "32", "--width", "128", "--views",
                          "2"])
    with pytest.raises(SystemExit):
        prop_ablate.main(["--device", "cpu", "--modes", "full,nope"])


def test_kernel_wrapper_takes_no_cpu_tensor(fields):
    planes = torch.as_tensor(fields["jcand"])
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        cuda_ablate.ablate_cuda("full", planes, None, TP)
    with pytest.raises(ValueError, match="mode"):
        cuda_ablate.ablate_cuda("nope", planes, None, TP)
    before = cuda_ablate.total_launches()
    tin = fields["tin"]
    prop_ablate.ablate_call("full", tin.ref_img, tin.src_imgs, fields["tvg"],
                            planes, TP, fields["joff0"], VIEWS)
    assert cuda_ablate.total_launches() == before


@pytest.mark.cuda
def test_kernel_modes_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import dataclasses

    from acmmp_tpu_torch.ops import cuda_ncc

    params, inputs, vg, cand, off0 = prop_ablate.build_fields(
        HEIGHT, WIDTH, VIEWS, device="cuda")
    prep = cuda_ablate.prepare(inputs.ref_img, inputs.src_imgs, vg, params,
                               off0)
    got = {m: cuda_ablate.ablate_cuda(m, cand, prep, params)
           for m in ablate.MODES}
    zncc = cuda_ncc.multiview_zncc_cuda(
        inputs.ref_img, inputs.src_imgs, vg, cand, params, row_pack_off=off0,
        prep=prep.zncc)
    # zncc.cu's current design and its first design give the same bits
    assert torch.equal(got["full"], zncc)
    assert torch.equal(got["first"], zncc)
    # f32take is zncc.cu's float instantiation on the widened sources
    wide = ablate.widen_sources(inputs.src_imgs)
    fparams = dataclasses.replace(params, ncc_src_u8=False)
    assert torch.equal(got["f32take"], cuda_ncc.multiview_zncc_cuda(
        inputs.ref_img, wide, vg, cand, fparams, row_pack_off=off0))
    assert torch.equal(got["f32take"], got["full"])
    for m in ("first", "full", "nobounds", "f32take"):
        want = ablate.ablate_packed(m, inputs.ref_img, inputs.src_imgs, vg,
                                    cand, params, off0)
        _zncc_bar(got[m].cpu().numpy(), want.cpu().numpy())
    for m in ("noext", "noscan"):
        want = ablate.ablate_packed(m, inputs.ref_img, inputs.src_imgs, vg,
                                    cand, params, off0)
        torch.testing.assert_close(got[m], want, rtol=1e-5, atol=1e-5)
        # under EXPOSING their costs rest on the sums they keep (the
        # chip_smoke.py phase 9c bars)
        xp = ablate.exposing_params(m, params)
        within, info, _ = ablate.exposed_agreement(
            cuda_ablate.ablate_cuda(m, cand, prep, xp),
            ablate.ablate_packed(m, inputs.ref_img, wide, vg, cand, xp,
                                 off0))
        assert info > 0.2
        assert within >= 0.99, (m, within)
    # the occupancy knob changes no bit
    for m in ablate.MODES:
        assert torch.equal(cuda_ablate.ablate_cuda(m, cand, prep, params,
                                                   smem_bytes=64 * 1024),
                           got[m])
