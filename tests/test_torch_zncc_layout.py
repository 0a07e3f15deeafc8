"""The source layout and the exact identities of acmmp_tpu_torch's ZNCC
kernel (csrc/zncc.cu), on the CPU.

The kernel reads each bilinear tap as one 32-bit 2x2 word that
ops/cuda_ncc.py::pack_2x2 builds, turns its bytes into f32 through the
mantissa (0x4B0000bb - 2^23) and floors a coordinate by adding 2^23
rounded down, so that its tap loop holds no conversion instruction. Here:
pack_2x2 against the four clamped bytes (odd sizes, a 1xN and an
Nx1 image, views smaller than the padded array); numpy emulations of the
two identities on every byte and on integers, integers +- 1 ulp, x.5, 0,
sx_max and 10^5 seeded values in [0, 3200); the whole read emulated both
ways (bytes with floorf, words with the identities), bitwise equal, and
held to the JAX package's bilinear_sample on the same 8-bit image. The
kernel itself runs only on a card: the cuda-marked test holds it bitwise
to csrc/ablate.cu's `first` (the kernel's first design) and K-stacks to
K = 1 launches at 128x32 / 3 views. JAX is imported only by the test
that uses it, so that the card test also runs where JAX is not installed:
`python -m pytest --noconftest -m cuda tests/test_torch_zncc_layout.py`."""

import pathlib
import re

import numpy as np
import pytest
import torch

from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.engine.inputs import build_solver_inputs
from acmmp_tpu_torch.ops import cuda_ncc
from acmmp_tpu_torch.ops import ncc as tncc
from acmmp_tpu_torch.utils.synth import textured_plane_scene

torch.set_num_threads(1)

# the tap code of csrc/zncc.cu, which it shares with csrc/ablate.cu
ZNCC_TAP = (pathlib.Path(__file__).resolve().parents[1] / "acmmp_tpu_torch"
            / "csrc" / "zncc_tap.cuh").read_text()
TWO23 = np.float32(2.0 ** 23)


def _cu_constant(name):
    """An integer constant of csrc/zncc.cu's tap code (zncc_tap.cuh), so
    that the emulation below uses the kernel's own selector and bit
    pattern."""
    m = re.search(rf"\b{name} = (0x[0-9A-Fa-f]+);", ZNCC_TAP)
    assert m, name
    return int(m.group(1), 16)


TWO23_BITS = _cu_constant("kTwo23Bits")
BYTE_SELECT = _cu_constant("kByteSelect")


def _byte_perm(x, y, s):
    """CUDA's __byte_perm on uint64 arrays holding 32-bit words: byte i of
    the result is byte (s >> 4i) & 7 of the 8 bytes {y:x}."""
    pool = [(x >> (8 * i)) & 0xFF for i in range(4)] + [
        (np.uint64(y) >> np.uint64(8 * i)) & np.uint64(0xFF)
        for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        nib = (s >> (4 * i)) & 0xF
        assert nib < 8, "sign-replicating selector"
        out |= pool[nib] << np.uint64(8 * i)
    return out


def _bytes_f32(q, n):
    """byte_f32<n>: byte n of the words q as f32 through the mantissa."""
    bits = _byte_perm(q.astype(np.uint64), TWO23_BITS, BYTE_SELECT + n)
    return bits.astype(np.uint32).view(np.float32) - TWO23


def _fadd_rd_two23(s):
    """__fadd_rd(s, 2^23) for f32 s >= 0 (-0 included) below 2^23. In f64
    the sum is exact when s >= 2^-6 (its last bit is at least 2^-29, the
    f64 spacing below 2^24); below that the nearest f32 is 2^23, which
    does not exceed the sum. So: the nearest f32, one step down where it
    lies above the exact sum."""
    exact = s.astype(np.float64) + 2.0 ** 23
    r = exact.astype(np.float32)
    return np.where(r.astype(np.float64) > exact,
                    np.nextafter(r, np.float32(0.0)), r)


def _floor_u23(s):
    """floor_u23: (floor as f32, floor as int)."""
    r = _fadd_rd_two23(s)
    return r - TWO23, r.view(np.int32).astype(np.int64) - TWO23_BITS


def _fma(a, b, c):
    """fmaf in f32 through f64 (the product of two f32 is exact there);
    both reads below use it alike."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _clamp(x, hi):
    """The NaN guard and clamp of the kernel's read."""
    return np.minimum(np.maximum(np.where(np.isnan(x), np.float32(0), x),
                                 np.float32(0)), hi)


def _bilerp(fx, fy, v00, v10, v01, v11):
    one = np.float32(1.0)
    a0 = one - fx
    top = _fma(fx, v10, a0 * v00)
    bot = _fma(fx, v11, a0 * v01)
    return _fma(fy, bot, (one - fy) * top)


def _byte_read(img, sx, sy, width, height):
    """The first design's read: floorf, (int), four clamped byte reads."""
    sx_max, sy_max = np.float32(width) - 1, np.float32(height) - 1
    xi_max, yi_max = int(sx_max), int(sy_max)
    sx, sy = _clamp(sx, sx_max), _clamp(sy, sy_max)
    xf, yf = np.floor(sx), np.floor(sy)
    x0, y0 = xf.astype(np.int64), yf.astype(np.int64)
    x1, y1 = np.minimum(x0 + 1, xi_max), np.minimum(y0 + 1, yi_max)
    v = [img[y, x].astype(np.float32)
         for y, x in ((y0, x0), (y0, x1), (y1, x0), (y1, x1))]
    return _bilerp(sx - xf, sy - yf, v[0], v[1], v[2], v[3])


def _word_read(words, sx, sy, width, height):
    """This design's read: floor_u23, one word, byte_f32."""
    sx_max, sy_max = np.float32(width) - 1, np.float32(height) - 1
    sx, sy = _clamp(sx, sx_max), _clamp(sy, sy_max)
    xf, x0 = _floor_u23(sx)
    yf, y0 = _floor_u23(sy)
    q = words.reshape(-1)[y0 * words.shape[1] + x0].view(np.uint32)
    return _bilerp(sx - xf, sy - yf, _bytes_f32(q, 0), _bytes_f32(q, 1),
                   _bytes_f32(q, 2), _bytes_f32(q, 3))


def _pack(src_u8, widths, heights):
    return cuda_ncc.pack_2x2(torch.as_tensor(src_u8),
                             torch.as_tensor(widths, dtype=torch.float32),
                             torch.as_tensor(heights, dtype=torch.float32))


# (padded shape [V, Hs, Ws], true widths, true heights)
LAYOUTS = {
    "odd sizes": ((2, 7, 13), (13, 13), (7, 7)),
    "1xN": ((1, 1, 9), (9,), (1,)),
    "Nx1": ((1, 9, 1), (1,), (9,)),
    "views smaller than the padded array": ((3, 8, 16), (11, 16, 5),
                                            (6, 8, 3)),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pack_2x2_holds_the_four_clamped_bytes(layout):
    shape, widths, heights = LAYOUTS[layout]
    src = np.random.default_rng(5).integers(0, 256, shape, dtype=np.uint8)
    got = _pack(src, widths, heights)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    q = got.numpy().view(np.uint32)
    for v, (w, h) in enumerate(zip(widths, heights)):
        # every word the read can touch: (x0, y0) inside the true extent
        for y in range(h):
            for x in range(w):
                x1, y1 = min(x + 1, w - 1), min(y + 1, h - 1)
                want = (int(src[v, y, x]), int(src[v, y, x1]),
                        int(src[v, y1, x]), int(src[v, y1, x1]))
                have = tuple((int(q[v, y, x]) >> (8 * n)) & 0xFF
                             for n in range(4))
                assert have == want, (layout, v, y, x)


def test_byte_through_the_mantissa_is_exact_for_every_byte():
    b = np.arange(256, dtype=np.uint64)
    assert np.array_equal(
        (np.uint64(TWO23_BITS) | b).astype(np.uint32).view(np.float32)
        - TWO23, b.astype(np.float32))
    # the kernel's selector picks byte n of a word under 0x4B0000
    words = np.random.default_rng(6).integers(0, 2 ** 32, 4096,
                                              dtype=np.uint64)
    for n in range(4):
        want = ((words >> np.uint64(8 * n)) & np.uint64(0xFF)).astype(
            np.float32)
        assert np.array_equal(_bytes_f32(words, n), want), n


def _floor_cases():
    ints = np.arange(3200, dtype=np.float32)
    up = np.nextafter(ints, np.float32(np.inf))
    down = np.nextafter(ints[1:], np.float32(0.0))
    rng = np.random.default_rng(7)
    return {
        "integers": ints,
        "integers + 1 ulp": up,
        "integers - 1 ulp": down,
        "x.5": ints + np.float32(0.5),
        "0, -0, sx_max, the largest below 2^23": np.array(
            [0.0, -0.0, 1599.0, 1663.0, 2.0 ** 23 - 1,
             np.nextafter(TWO23, np.float32(0.0))], np.float32),
        "1e5 seeded in [0, 3200)": (rng.random(100_000) * 3200).astype(
            np.float32),
    }


@pytest.mark.parametrize("case", sorted(_floor_cases()))
def test_floor_by_round_down_add_is_exact(case):
    s = _floor_cases()[case]
    xf, x0 = _floor_u23(s)
    assert np.array_equal(xf, np.floor(s)), case
    assert np.array_equal(x0, np.floor(s).astype(np.int64)), case
    # the fraction is the same f32 value (a zero fraction may differ in
    # sign at s = -0, which no later rounding sees: 1 - fx is 1 either
    # way and fma(+-0, v, c) is c)
    assert np.array_equal(s - xf, s - np.floor(s)), case


def test_word_read_bitwise_equals_byte_read_and_holds_to_jax():
    import jax.numpy as jnp

    from acmmp_tpu.core import geometry as jgeo

    rng = np.random.default_rng(8)
    V, Hs, Ws = 2, 24, 40
    widths, heights = (37, 40), (21, 24)
    src = rng.integers(0, 256, (V, Hs, Ws), dtype=np.uint8)
    words = _pack(src, widths, heights).numpy()
    for v in range(V):
        w, h = widths[v], heights[v]
        n = 20_000
        sx = (rng.random(n) * (w + 8) - 4).astype(np.float32)
        sy = (rng.random(n) * (h + 8) - 4).astype(np.float32)
        # integers, the far edges, -0, NaN and infinities
        sx[:64] = np.arange(64) % (w + 2)
        sy[64:128] = np.arange(64) % (h + 2)
        sx[128:132] = (np.nan, -0.0, np.inf, -np.inf)
        sy[132:136] = (np.nan, -0.0, np.inf, -np.inf)
        old = _byte_read(src[v], sx, sy, w, h)
        new = _word_read(words[v], sx, sy, w, h)
        assert np.array_equal(old.view(np.int32), new.view(np.int32)), v
        finite = np.isfinite(sx) & np.isfinite(sy)
        want = np.asarray(jgeo.bilinear_sample(
            jnp.asarray(src[v].astype(np.float32)), jnp.asarray(sx[finite]),
            jnp.asarray(sy[finite]), float(w), float(h)))
        np.testing.assert_allclose(new[finite], want, rtol=0, atol=2e-4)


def _scene_inputs(device, num_views_pad=None):
    images, cams, _ = textured_plane_scene(n_views=4, width=128, height=32,
                                           f=240.0, plane_z=5.0)
    return build_solver_inputs(images[0], images[1:], cams[0], cams[1:],
                               PatchMatchParams(),
                               num_views_pad=num_views_pad, device=device)


def test_prepare_builds_the_words_once_per_solve():
    params = PatchMatchParams()
    inp = _scene_inputs("cpu", num_views_pad=4)
    vg = tncc.make_view_geometry(inp.ref_cam, inp.src_cams)
    full = cuda_ncc.prepare(inp.ref_img, inp.src_imgs, vg, params)
    packed = cuda_ncc.prepare(inp.ref_img, inp.src_imgs, vg, params, 1,
                              shared=full)
    for name in ("src_u8", "src_q", "consts", "taps"):
        assert getattr(packed, name) is getattr(full, name), name
    assert torch.equal(full.src_q, cuda_ncc.pack_2x2(
        full.src_u8, vg.src_width, vg.src_height))
    # an 8-bit prep builds no float quads
    assert full.src_type == "u8" and full.src_f4 is None
    alone = cuda_ncc.prepare(inp.ref_img, inp.src_imgs, vg, params, 1)
    for a, b in zip(packed, alone):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b
    T = len(params.tap_offsets) ** 2
    H, W = inp.ref_img.shape
    assert tuple(packed.w_taps.shape) == (T, H // 2, W)
    assert packed.row_pack_off == 1 and full.row_pack_off == -1


def test_wrapper_takes_no_cpu_tensor():
    params = PatchMatchParams()
    inp = _scene_inputs("cpu")
    vg = tncc.make_view_geometry(inp.ref_cam, inp.src_cams)
    H, W = inp.ref_img.shape
    before = cuda_ncc.total_launches()
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        cuda_ncc.multiview_zncc_cuda(inp.ref_img, inp.src_imgs, vg,
                                     torch.zeros((8, H // 2, W, 4)), params,
                                     row_pack_off=0)
    assert cuda_ncc.total_launches() == before


@pytest.mark.cuda
def test_kernel_bitwise_to_first_design_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from acmmp_tpu_torch.ops import cuda_ablate
    from acmmp_tpu_torch.tools import prop_ablate

    params, inputs, vg, cand, off0 = prop_ablate.build_fields(
        32, 128, 3, device="cuda")
    aprep = cuda_ablate.prepare(inputs.ref_img, inputs.src_imgs, vg, params,
                                off0)

    def zncc(planes):
        return cuda_ncc.multiview_zncc_cuda(
            inputs.ref_img, inputs.src_imgs, vg, planes.contiguous(), params,
            row_pack_off=off0, prep=aprep.zncc)

    got = zncc(cand)
    assert torch.equal(got, cuda_ablate.ablate_cuda("first", cand, aprep,
                                                    params))
    singles = [zncc(cand[k:k + 1]) for k in range(8)]
    assert torch.equal(torch.cat(singles), got)
    for K in (2, 3):
        assert torch.equal(zncc(cand[:K]), got[:K]), K
    assert float(got.min()) < params.cost_max     # informative costs
