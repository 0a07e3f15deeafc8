"""[The benchmark's plain reference: a frozen copy of the program's
`acmmp_tpu_torch/config.py`, its plain (non-kernel) path only, importing
nothing of the program. Its original text follows.]

Configuration for the PatchMatch engine and pipeline.

A copy of ``acmmp_tpu/config.py`` with the same fields and defaults, kept
here so the PyTorch port imports nothing of the JAX package. Fields that
only schedule work on the TPU (``ncc_prop_substacks``,
``ncc_kbatch_coherent``, ``ncc_kbatch_refine``) are kept for parity and
ignored: they never change a result (the port always scores the
refinement candidates as the K=3 + K=2 stacks). ``ncc_backend`` takes the
port's values (see the field).

Every named constant of the reference implementation is surfaced here
(reference: PatchMatchParams defaults at src/ACMMP.h:32-56, Problem_config at
src/acmmp_definitions.h:34-45, plus the inline magic numbers cited per-field).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class PatchMatchParams:
    """Static parameters of the per-view PatchMatch solver.

    These are hashable/static under jit; per-problem dynamic values (depth
    range, view count) live in the solver inputs instead.
    """

    # --- core schedule (src/ACMMP.h:33-41) ---
    max_iterations: int = 2          # red/black sweep pairs per pass
    patch_size: int = 11             # NCC window (taps every radius_increment)
    radius_increment: int = 2        # tap stride -> 6x6 = 36 taps
    sigma_spatial: float = 5.0       # bilateral spatial sigma
    sigma_color: float = 3.0         # bilateral color sigma
    top_k: int = 4                   # views averaged for the initial cost
    max_image_size: int = 3200       # hard cap on the finest scale
    size_bound: int = 1000           # coarsest-scale bound (acmmp_definitions.cpp:210)
    baseline: float = 0.54           # only used for disparity bookkeeping

    # --- cost model ---
    cost_max: float = 2.0            # NCC clamp (ACMMP.cu:362)
    min_var: float = 1e-5            # degenerate-variance guard (ACMMP.cu:423)
    geom_cost_max: float = 3.0       # reprojection clamp (ACMMP.cu:520)
    geom_weight: float = 0.2         # geometric-consistency weight (ACMMP.cu:753,1064)
    # NB: the reference's 0.1*3.0 penalty for invalid-flag candidates in
    # geom mode (ACMMP.cu:1067) is part of the zero-cost border hijack we
    # do not reproduce — invalid candidates are BIG-masked in every mode
    # (DEVIATIONS.md #7)

    # --- multi-hypothesis joint view selection (ACMMP.cu:994-1056) ---
    view_prior_selected: float = 0.9
    view_prior_unselected: float = 0.1
    cost_threshold_base: float = 0.8       # 0.8*exp(iter^2/-90)
    cost_threshold_decay: float = 90.0
    cost_good_beta: float = 0.18           # exp(c^2/-0.18) evidence weight
    cost_fallback_beta: float = 0.32       # exp(thr^2/-0.32) fallback
    cost_false_threshold: float = 1.2      # c > 1.2 counts as a bad view
    min_good_hypotheses: int = 2           # need count > 2 for direct evidence
    max_false_hypotheses: int = 3          # need count_false < 3 at all
    num_view_samples: int = 15             # Monte-Carlo CDF samples

    # --- adaptive checkerboard sampling (ACMMP.cu:804-992) ---
    far_strip_candidates: int = 11   # far strips: base + 10 extra at stride 2
    near_v_levels: int = 3           # near V regions: base + 3 diagonal levels

    # --- refinement (ACMMP.cu:707-784) ---
    refine_perturbation: float = 0.02
    prior_gamma: float = 0.5
    prior_beta: float = 0.18
    prior_depth_sigma_div: float = 64.0    # sigma_d = (dmax-dmin)/64
    prior_angle_sigma: float = math.pi * 5.0 / 180.0

    # --- planar-prior init perturbation (ACMMP.cu:641-650) ---
    prior_init_perturbation: float = 0.02  # scaled x3 in the init kernel

    # --- hierarchy (ACMMP.cu:1163-1168) ---
    hierarchy_accept_margin: float = 0.1

    # --- median filter (ACMMP.cu:1245) ---
    filter_cost_skip: float = 0.001

    # --- JBU (ACMMP.cu:1472-1476) ---
    jbu_sigma_d: float = 0.5
    jbu_sigma_r: float = 25.5

    # --- depth-range relaxation (ACMMP.cpp:600-601) ---
    depth_min_relax: float = 0.6
    depth_max_relax: float = 1.2

    # --- NCC backend: "auto" = the CUDA kernel for CUDA tensors and the
    # plain PyTorch version for CPU tensors; "plain" forces the plain
    # version (the kernel's yardstick); "cuda" forces the kernel and raises
    # on CPU tensors (ops/ncc.py) ---
    ncc_backend: str = "auto"        # "auto" | "plain" | "cuda"
    # the reference only: the dtype of the ZNCC's bilateral moments;
    # "bfloat16" is the correctness check's control
    zncc_dtype: str = "float32"
    # Treat source images as 8-bit (build_solver_inputs rounds them to
    # uint8 values; the CUDA kernel reads them as uint8). This is the
    # reference's own precision — its CUDA textures sample uint8 Mats
    # (acmmp_definitions.cpp BindTextures). The kernel takes only u8
    # sources; False keeps full-float sources on the plain version.
    ncc_src_u8: bool = True
    # Evaluate each red/black half-sweep's hypothesis costs on a parity
    # row-packed half grid (ops/parity.py): half the work in the hot op,
    # identical update rule.
    parity_packed: bool = True
    # TPU scheduling of the JAX package's Pallas kernels; ignored here
    # (the K-stack costs equal K single scorings, csrc/zncc.cu).
    ncc_kbatch_coherent: bool = True
    ncc_kbatch_refine: bool = True
    ncc_prop_substacks: str = "auto"
    # DEFAULT-ON deviation (set 0 for exact reference semantics): draw
    # each random depth (init planes + the two d_rand refinement
    # candidates) inside a per-(16,128)-GLOBAL-tile random subrange of
    # this fraction of the depth range, refreshed every call/sweep. Same
    # per-pixel marginal support, trapezoidal instead of uniform at the
    # range edges (DEVIATIONS.md #18). The JAX package adopted it for its
    # TPU kernel's scan cost after a quality gate (QUALITY.md); the port
    # keeps the same default so both solve the same problem.
    rand_depth_tile_window: float = 0.125
    # The windowed draw needs enough (16, 128) window tiles for
    # exploration diversity: below this many tiles on the FULL padded
    # image grid the solver falls back to the exact full-range draw
    # (quality holds at 320x240 = 45 tiles, regresses at 96x64 = 4 tiles —
    # tests/test_relief.py).
    rand_window_min_tiles: int = 24
    # DEFAULT-ON deviation (set 0 for exact reference law): draw random
    # normals uniformly on the spherical cap dot(n, -view_dir) >= c
    # instead of the full facing hemisphere (DEVIATIONS.md #19); kept for
    # the same reason as rand_depth_tile_window.
    rand_normal_min_cos: float = 0.25

    # --- deviations from the reference (documented in DEVIATIONS.md) ---
    # The reference's right_far strip selects the MAX-cost member due to a
    # reversed comparison (ACMMP.cu:879); we default to the evident intent
    # (min-cost, consistent with the other 7 directions).
    reproduce_right_far_quirk: bool = False

    @property
    def patch_radius(self) -> int:
        return self.patch_size // 2

    @property
    def tap_offsets(self) -> tuple:
        r = self.patch_radius
        return tuple(range(-r, r + 1, self.radius_increment))
