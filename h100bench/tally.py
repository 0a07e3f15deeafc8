"""The work a solve needs, counted from the problem's true sizes and
the solver's schedule, never from launch shapes: the yardstick of the
rooflines.

Per launch, as (operations, bytes), each input read and each output
written once:

* ZNCC (`zncc.cu`): 40 FP32 operations per (hypothesis, view, tap,
  pixel); bytes: the reference pixel (4), every source pixel (1, 8-bit
  sources; 4 for float sources), each hypothesis' plane (16) and its V
  costs (4 each).
* Geometric cost (`geom.cu`): 141 operations per (hypothesis, view,
  pixel) plus 6 per (view, pixel); bytes: every source depth pixel (4),
  the planes (16) and the V costs (4 each).

A solve scores one hypothesis on every pixel at its init, then in each
of its 2 * max_iterations half-sweeps 8 propagation and 3 + 2
refinement hypotheses on the pixels of one checkerboard colour (the
parity packing), black first; a geometric solve scores the same with
its K=8 and K=5 geometric launches."""

from __future__ import annotations

ZNCC_OPS = 40
GEOM_OPS_HYP = 141
GEOM_OPS_PIXEL = 6


def colours(H: int, W: int):
    """(black, red) pixel counts of an H x W checkerboard, black at
    (x + y) even."""
    black = (H * W + 1) // 2
    return black, H * W - black


def zncc_launches(H: int, W: int, V: int, pm: dict) -> list:
    """[(operations, bytes)] of one solve's ZNCC launches."""
    taps = len(range(-(pm["patch_size"] // 2), pm["patch_size"] // 2 + 1,
                     pm["radius_increment"])) ** 2
    src_px = 1 if pm["ncc_src_u8"] else 4
    black, red = colours(H, W)

    def launch(K, n):
        ops = ZNCC_OPS * taps * V * K * n
        nbytes = 4 * n + src_px * V * H * W + 16 * K * n + 4 * K * n * V
        return ops, nbytes

    out = [launch(1, H * W)]
    for s in range(2 * pm["max_iterations"]):
        n = black if s % 2 == 0 else red
        out += [launch(8, n), launch(3, n), launch(2, n)]
    return out


def geom_launches(H: int, W: int, V: int, pm: dict) -> list:
    """[(operations, bytes)] of one geometric solve's geom launches."""
    black, red = colours(H, W)

    def launch(K, n):
        ops = V * (GEOM_OPS_HYP * K * n + GEOM_OPS_PIXEL * n)
        nbytes = 4 * V * H * W + 16 * K * n + 4 * K * n * V
        return ops, nbytes

    out = [launch(1, H * W)]
    for s in range(2 * pm["max_iterations"]):
        n = black if s % 2 == 0 else red
        out += [launch(8, n), launch(5, n)]
    return out


def solve(H: int, W: int, V: int, pm: dict, geometric: bool) -> dict:
    """The tally of one solve: {kernel: [(operations, bytes)]}."""
    out = {"zncc": zncc_launches(H, W, V, pm)}
    if geometric:
        out["geom"] = geom_launches(H, W, V, pm)
    return out


def bound_s(launches, peaks: dict) -> float:
    """The least time the card can take for `launches`: per launch the
    larger of operations over peak FP32 rate and bytes over peak
    bandwidth, summed."""
    return sum(max(ops / peaks["fp32_flops"], b / peaks["hbm_bytes_per_s"])
               for ops, b in launches)

