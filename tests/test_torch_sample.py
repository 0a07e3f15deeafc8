"""The fusion sampler of acmmp_tpu_torch (ops/sample.py) against the JAX
package's jnp oracle (acmmp_tpu/ops/sample.py::gather2d) on the five cases
of tests/test_pallas_sample.py, CPU. Both move whole f32 words with no
arithmetic, so the bar is bitwise. The CUDA kernel (csrc/sample.cu) is
held bitwise to the plain version on the card by the cuda-marked test and
by chip_smoke.py phase 3d."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmmp_tpu.ops.sample import gather2d as jax_gather2d
from acmmp_tpu_torch.ops import cuda_sample
from acmmp_tpu_torch.ops import sample as tsample

torch.set_num_threads(1)


def _coherent(rng):
    V, C, Hs, Ws = 2, 3, 32, 128
    H, W = 16, 128
    maps = rng.normal(size=(V, C, Hs, Ws)).astype(np.float32)
    y, x = np.mgrid[:H, :W]
    rr = np.clip((0.9 * y + 0.02 * x + 3).astype(np.int32), 0, Hs - 1)
    cc = np.clip((0.97 * x + 0.1 * y + 1).astype(np.int32), 0, Ws - 1)
    rr = np.broadcast_to(rr, (V, H, W)).copy()
    cc = np.broadcast_to(cc, (V, H, W)).copy()
    return maps, rr, cc, np.ones((V, H, W), bool)


def _scattered(rng):
    V, C, Hs, Ws = 2, 2, 40, 256
    H, W = 8, 128
    maps = rng.normal(size=(V, C, Hs, Ws)).astype(np.float32)
    rr = rng.integers(0, Hs, (V, H, W)).astype(np.int32)
    cc = rng.integers(0, Ws, (V, H, W)).astype(np.int32)
    return maps, rr, cc, np.ones((V, H, W), bool)


def _garbage(rng):
    V, C, Hs, Ws = 1, 2, 24, 128
    H, W = 8, 128
    maps = rng.normal(size=(V, C, Hs, Ws)).astype(np.float32)
    rr = np.clip(rng.integers(8, 16, (V, H, W)), 0, Hs - 1).astype(np.int32)
    cc = rng.integers(0, Ws, (V, H, W)).astype(np.int32)
    valid = rng.random((V, H, W)) < 0.7
    rr[~valid] = np.int32(-2147483648)       # NaN cast garbage
    cc[~valid] = np.int32(2147483647)
    return maps, rr, cc, valid


def _all_invalid(rng):
    return (np.ones((1, 1, 16, 128), np.float32),
            np.zeros((1, 8, 128), np.int32), np.zeros((1, 8, 128), np.int32),
            np.zeros((1, 8, 128), bool))


def _unaligned(rng):
    V, C, Hs, Ws = 2, 4, 21, 100
    H, W = 13, 77
    maps = rng.normal(size=(V, C, Hs, Ws)).astype(np.float32)
    rr = rng.integers(0, Hs, (V, H, W)).astype(np.int32)
    cc = rng.integers(0, Ws, (V, H, W)).astype(np.int32)
    return maps, rr, cc, rng.random((V, H, W)) < 0.9


CASES = {"coherent": (_coherent, 0), "scattered": (_scattered, 1),
         "garbage": (_garbage, 2), "all_invalid": (_all_invalid, 0),
         "unaligned": (_unaligned, 3)}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_gather2d_bitwise_against_jax(name):
    make, seed = CASES[name]
    maps, rr, cc, valid = make(np.random.default_rng(seed))
    got = tsample.gather2d(*(torch.as_tensor(a) for a in (maps, rr, cc,
                                                          valid)))
    want = np.asarray(jax_gather2d(*(jnp.asarray(a) for a in (maps, rr, cc,
                                                              valid))))
    assert got.shape == want.shape == maps.shape[:2] + rr.shape[1:]
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    # invalid lanes read 0 whatever their indices hold
    assert (got.permute(0, 2, 3, 1)[torch.as_tensor(~valid)] == 0.0).all()


def test_dispatch_on_cpu_tensors():
    maps, rr, cc, valid = (torch.as_tensor(a) for a in
                           _garbage(np.random.default_rng(5)))
    before = cuda_sample.total_launches()
    auto = tsample.gather2d_sample(maps, rr, cc, valid)
    plain = tsample.gather2d_sample(maps, rr, cc, valid, backend="plain")
    assert torch.equal(auto, plain)
    assert cuda_sample.total_launches() == before
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        tsample.gather2d_sample(maps, rr, cc, valid, backend="cuda")
    with pytest.raises(ValueError, match="sample_backend"):
        tsample.gather2d_sample(maps, rr, cc, valid, backend="pallas")


@pytest.mark.cuda
def test_kernel_bitwise_against_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for name, (make, seed) in CASES.items():
        maps, rr, cc, valid = (torch.as_tensor(a, device="cuda") for a in
                               make(np.random.default_rng(seed)))
        got = tsample.gather2d_sample(maps, rr, cc, valid)
        want = tsample.gather2d_sample(maps, rr, cc, valid, backend="plain")
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            name
