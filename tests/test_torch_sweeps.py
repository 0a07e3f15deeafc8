"""Half-sweeps of acmmp_tpu_torch's planar-prior and hierarchy modes
against the JAX package's eager sweep_once on the same state, inputs and
key (CPU). A file of its own, beside tests/test_torch_modes.py whose
problem it shares, so that xdist runs the two on different workers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmmp_tpu.engine import patchmatch as jpm
from acmmp_tpu.engine.inputs import build_solver_inputs as jax_inputs
from acmmp_tpu.ops import ncc as jncc
from acmmp_tpu_torch.engine import patchmatch as tpm
from acmmp_tpu_torch.engine.inputs import solver_inputs_from_numpy
from acmmp_tpu_torch.ops import keys
from acmmp_tpu_torch.ops import ncc as tncc

from .test_torch_modes import JP, TP, problem  # noqa: F401 (fixture)
from .util import textured_plane_scene as jax_scene

torch.set_num_threads(1)

# share of a half-sweep's active pixels whose new plane agrees with the JAX
# sweep's from the same state, with the JAX package's ZNCC swapped into the
# port (test_sweep_matches_jax; measured 0.9909-0.9935)
SWEEP_MIN_SHARE = 0.985


def _agree(a, b, active):
    """Share of the active pixels where two [H, W, 4] plane fields agree
    within 1e-4 in every component."""
    close = (np.abs(np.asarray(a) - np.asarray(b)) <= 1e-4).all(-1)
    return close[active].mean()


def _jax_zncc(jvg):
    """The JAX package's plain ZNCC, with its own view geometry, in place
    of the port's (same signature, same layout): with it the port's sweep
    differs from the JAX sweep only in its own logic and f32 geometry.
    Eager, as the JAX sweep runs it here: a jitted ZNCC rounds
    differently. The port's one-view sweep is its batched sweep on a
    batch of one, so its reference side, sources and planes carry a batch
    axis of 1, which the bridge takes off for the JAX call and puts back
    on its costs."""
    def zncc(ref_center, tap_values, x, y, src_imgs, vg, planes, params):
        j = lambda t: jnp.asarray(t.numpy()[0])                 # noqa: E731
        out = jncc._zncc_grids(
            j(ref_center), [j(t) for t in tap_values],
            jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), j(src_imgs), jvg,
            jnp.asarray(planes.squeeze(-4).numpy()), JP)
        return torch.as_tensor(np.array(out)).unsqueeze(-4)
    return zncc


def _swap_zncc(fn, sweep, *args):
    clean = tncc._zncc_grids
    tncc._zncc_grids = fn
    try:
        return sweep(*args)
    finally:
        tncc._zncc_grids = clean


@pytest.mark.parametrize("flags, sweep", [(("planar_prior",), 0),
                                          (("hierarchy", "planar_prior"), 1),
                                          (("hierarchy",), 0)])
def test_sweep_matches_jax(problem, flags, sweep):
    """The sweep branches of the planar prior and the hierarchy against the
    JAX package's eager sweep_once: the restricted-score acceptance of
    propagation and refinement, the prior's refinement draws, and the
    hierarchy gate with its buffer fallback (pre-costs slack on the left
    half, converged on the right, so the gate both opens and shuts). The
    half-sweep (black for sweep 0, red for 1) starts both packages from
    the JAX init state with the same key; the new planes are compared on
    the active parity.

    With the JAX package's ZNCC and view geometry swapped into the port,
    the sweeps differ only in their own arithmetic: at least
    SWEEP_MIN_SHARE of the pixels agree (the rest are ties of the
    restricted score, saturated at prior_gamma and a last-ulp apart, and
    argmin near-ties). With the port's own centred ZNCC, which differs
    from the JAX package's by a standard deviation of about 5e-5 on these
    init costs, more near-ties flip, so that share is held to the port's
    agreement with itself under Gaussian ZNCC noise of the measured
    size (0.71-0.93 against 0.77-0.96 across packages)."""
    p = problem
    cost = p["kw"]["init_cost"]
    pre = cost.copy()
    pre[:, : cost.shape[1] // 2] += 1.0
    kw = dict(p["kw"], pre_costs=pre, seed_planes=None, src_depths=None)
    images, cams, _ = jax_scene(n_views=4, width=64, height=48)
    jin = jax_inputs(images[0], images[1:], cams[0], cams[1:], JP, pad_h=1,
                     pad_w=1, **kw)
    key = jax.random.key(11)
    tin, tkey = solver_inputs_from_numpy(jax.tree.map(np.asarray, jin),
                                         jax.random.key_data(key),
                                         device="cpu")
    jmode = jpm.Mode(**{f: True for f in flags})
    tmode = tpm.Mode(**{f: True for f in flags})
    h, w = cost.shape
    black = (np.add.outer(np.arange(h), np.arange(w)) % 2) == 0
    jstate = jpm.init_state(jin, key, JP, jmode)
    sigma = float((tpm.one_view(tpm.init_state, tin, tkey, TP,
                                tmode).ncc_pv.numpy()
                   - np.asarray(jstate.ncc_pv)).std())
    clean, gen = tncc._zncc_grids, torch.Generator().manual_seed(0)

    def noisy(*args):
        c = clean(*args)
        return c + sigma * torch.randn(c.shape, generator=gen)

    bridge = _jax_zncc(jncc.make_view_geometry(jin.ref_cam, jin.src_cams))
    s = sweep
    tstate = tpm.SolverState(*(None if a is None else torch.as_tensor(
        np.array(a)) for a in jstate))
    jnext = jpm.sweep_once(jstate, jin, s, jax.random.fold_in(key, s), JP,
                           jmode)
    args = (tpm.sweep_once, tstate, tin, s, keys.fold_in(tkey, s), TP,
            tmode)
    tnext = tpm.one_view(*args)
    tnoisy = _swap_zncc(noisy, tpm.one_view, *args)
    tjax = _swap_zncc(bridge, tpm.one_view, *args)
    active = (black if s % 2 == 0 else ~black)
    jp, tp = np.asarray(jnext.planes)[:h, :w], tnext.planes[:h, :w]
    bridged = _agree(tjax.planes[:h, :w], jp, active)
    share = _agree(tp, jp, active)
    nshare = _agree(tnoisy.planes[:h, :w], tp, active)
    assert bridged >= SWEEP_MIN_SHARE, (bridged, share, nshare)
    assert share >= nshare - 0.02, (bridged, share, nshare)
    prev = tstate.planes[:h, :w]
    assert _agree(tp, prev, active) < 0.9      # the sweep moved planes
    if "hierarchy" in flags:
        # the gate shut on the converged right half: (nearly) every pixel
        # there keeps its pre-sweep plane, unlike the left half
        left, right = active.copy(), active.copy()
        left[:, w // 2:] = right[:, : w // 2] = False
        assert _agree(tp, prev, right) > 0.95
        assert _agree(tp, prev, left) < 0.9
