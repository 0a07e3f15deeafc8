"""acmmp_tpu_torch's lane probes (ops/probes.py, tools/mosaic_probe.py)
against the JAX package's Pallas probes in interpret mode and against
numpy, bitwise, on the probe tool's words and on nan_take_probe's
adversarial ones (signalling and quiet NaNs, +inf, -0, -sNaN).

tools/mosaic_probe.py runs its probes when it is imported, so its four
kernel bodies are restated here from mosaic_probe.py:36-55, and
nan_take_probe's two from prop_ablate.py:451-458; each runs through
pl.pallas_call under pltpu.force_tpu_interpret_mode(). The kernels of
csrc/probes.cu run only on a card (the cuda-marked tests, chip_smoke.py
phase 9); JAX is imported only where it is installed, so that they also
run without it: `python -m pytest --noconftest -m cuda
tests/test_torch_probes.py`."""

import importlib
import io
import contextlib

import numpy as np
import pytest
import torch

from acmmp_tpu_torch.ops import cuda_probes, probes
from acmmp_tpu_torch.tools import mosaic_probe, prop_ablate

try:
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
except ImportError:      # a card machine without JAX: the card tests only
    jax = None

torch.set_num_threads(1)


# mosaic_probe.py:36-55
def k_taa_i32(w_ref, i_ref, o_ref):
    o_ref[...] = jnp.take_along_axis(w_ref[...], i_ref[...], axis=1)


def k_dyn_shift(w_ref, s_ref, o_ref):
    v = jax.lax.shift_right_logical(w_ref[...], s_ref[...])
    o_ref[...] = (v & 0xFF).astype(jnp.float32)


def k_unpack(w_ref, o_ref):
    w = w_ref[...]
    acc = jnp.zeros(w.shape, jnp.float32)
    for k in range(4):
        b = (jax.lax.shift_right_logical(w, jnp.int32(8 * k)) & 0xFF)
        acc = acc + b.astype(jnp.float32)
    o_ref[...] = acc


def k_taa_axis0_i32(w_ref, i_ref, o_ref):
    o_ref[...] = jnp.take_along_axis(w_ref[...], i_ref[...] % 8, axis=0)


# prop_ablate.py:451-458
def k_i32(w_ref, i_ref, s_ref, o_ref):
    g = jnp.take_along_axis(w_ref[...], i_ref[...], axis=1)
    o_ref[...] = jnp.where(s_ref[...], g, w_ref[...])


def k_f32(w_ref, i_ref, s_ref, o_ref):
    wf = pltpu.bitcast(w_ref[...], jnp.float32)
    g = jnp.take_along_axis(wf, i_ref[...], axis=1)
    o_ref[...] = pltpu.bitcast(jnp.where(s_ref[...], g, wf), jnp.int32)


# each probe: its Pallas kernel, output dtype and argument names
CASES = {
    "taa_i32_axis1": (k_taa_i32, np.int32, ("w", "idx")),
    "taa_i32_axis0": (k_taa_axis0_i32, np.int32, ("w", "idx")),
    "dyn_lane_shift": (k_dyn_shift, np.float32, ("w", "sh")),
    "unpack4_static": (k_unpack, np.float32, ("w",)),
    "take_select_i32": (k_i32, np.int32, ("w", "idx", "sel")),
    "take_select_f32": (k_f32, np.int32, ("w", "idx", "sel")),
}


def _inputs(kind):
    """numpy [8, 128] inputs: the probe tool's, or nan_take_probe's
    adversarial words with the probe tool's shifts."""
    words, idx, sh = mosaic_probe.probe_inputs(0)
    sel = np.random.default_rng(1).integers(0, 2, (8, 128)) == 1
    if kind == "adversarial":
        words, idx, sel = prop_ablate.adversarial_words()
    return dict(w=words, idx=idx, sh=sh, sel=sel)


def test_probe_table_covers_every_probe():
    assert tuple(CASES) == probes.PROBES


@pytest.mark.parametrize("kind", ["words", "adversarial"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_probe_matches_pallas_and_numpy(name, kind):
    kernel, dtype, names = CASES[name]
    arrs = [_inputs(kind)[n] for n in names]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct((8, 128), dtype),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * len(arrs),
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        )(*[jnp.asarray(a) for a in arrs]))
    got = probes.run(name, *[torch.as_tensor(a) for a in arrs]).numpy()
    assert got.dtype == want.dtype
    # bitwise: compare the 32-bit patterns
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(
        got.view(np.int32), probes.numpy_reference(
            name, *(_inputs(kind)[n] for n in ("w", "idx", "sh", "sel"))
        ).view(np.int32))


def test_f32_select_keeps_nan_payloads():
    a = _inputs("adversarial")
    args = [torch.as_tensor(a[n]) for n in ("w", "idx", "sel")]
    f32 = probes.run("take_select_f32", *args)
    assert torch.equal(f32, probes.run("take_select_i32", *args))
    # the planted signalling NaNs pass through unquieted where unselected
    keep = ~a["sel"][0, :16]
    assert (f32.numpy()[0, :16][keep] == np.int32(0x7F800001)).all()


def test_mosaic_probe_main_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mosaic_probe.main(["--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert rc == 0, lines
    for name in ("taa_i32_axis1", "dyn_lane_shift", "unpack4_static",
                 "taa_i32_axis0"):
        assert any(ln.startswith(f"{name}: OK") for ln in lines), lines
    assert "taa_i32 exact: True" in lines
    assert "dyn_shift exact: True" in lines


def test_mosaic_probe_does_nothing_at_import(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        importlib.reload(mosaic_probe)
    assert out.getvalue() == ""
    # and it asks for CUDA unless told otherwise
    with pytest.raises(RuntimeError, match="CUDA"):
        mosaic_probe.main([])


def test_kernel_wrapper_takes_no_cpu_tensor():
    w = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        cuda_probes.probe_cuda("unpack4_static", w)
    with pytest.raises(ValueError, match="probe"):
        cuda_probes.probe_cuda("nope", w)
    before = cuda_probes.total_launches()
    probes.run("unpack4_static", w)
    assert cuda_probes.total_launches() == before


@pytest.mark.cuda
def test_probe_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for kind in ("words", "adversarial"):
        a = _inputs(kind)
        for name, (_k, _d, names) in CASES.items():
            cpu = [torch.as_tensor(a[n]) for n in names]
            got = probes.run(name, *[t.cuda() for t in cpu]).cpu()
            want = probes.run(name, *cpu)
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), (name, kind)

