"""Joint bilateral upsampling between scales — the port of
``acmmp_tpu/ops/jbu.py``:
  * `jbu_depth`, the depth upsampler (JBU_cu, src/ACMMP.cu:1458-1516) that
    gives the next scale its initial depths;
  * `jbu_normal_cost`, the hierarchy-init upscaler of (normal, cost)
    fields (upscale_normal, src/ACMMP.cu:548-607).

Window: Imagescale = max(H // Hc, W // Wc), num_neighbors =
(Imagescale^2 + 1) // 2 (ACMMP.cu:1472-1476); sigma_d = 0.5 in coarse
pixel units, sigma_r = 25.5 grey levels.

Both sampling forms of the JAX package are kept: for an integer ratio
(the pipeline halves sizes) each coarse tap is s*s edge-clamped static
shifts of the nearest-upsampled coarse map, selected by the pixel's
residue class (y % s, x % s); any other ratio reads the coarse map at the
clamped tap indices. The two read the same values. The JAX module
reaches no Pallas kernel, so this is plain tensor code.
"""

from __future__ import annotations

import torch

from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.core import geometry as geo
from acmmp_tpu_torch.ops.ncc import _shift_edge


def _window(fine_shape, coarse_shape):
    H, W = fine_shape
    Hc, Wc = coarse_shape
    imagescale = max(H // Hc, W // Wc)
    num_neighbors = (imagescale * imagescale + 1) // 2
    scale = Wc / W
    return num_neighbors, scale


def _weights(fine_gray, coarse_shape, num_neighbors, scale,
             params: PatchMatchParams):
    """Per tap (j, i, coarse row / column indices, weight)."""
    H, W = fine_gray.shape
    Hc, Wc = coarse_shape
    x, y = geo.pixel_grid(H, W, device=fine_gray.device)
    ox = x * scale
    oy = y * scale
    bx = torch.floor(ox).long()
    by = torch.floor(oy).long()
    inv_2sd2 = 1.0 / (2.0 * params.jbu_sigma_d ** 2)
    inv_2sr2 = 1.0 / (2.0 * params.jbu_sigma_r ** 2)

    taps = []
    for j in range(-num_neighbors, num_neighbors + 1):
        for i in range(-num_neighbors, num_neighbors + 1):
            rx = torch.clamp(bx + i, 0, Wc - 1)
            ry = torch.clamp(by + j, 0, Hc - 1)
            sdist = (ox - rx.float()) ** 2 + (oy - ry.float()) ** 2
            sgauss = torch.exp(-sdist * inv_2sd2)
            d = torch.abs(fine_gray - _shift_edge(fine_gray, j, i))
            rgauss = torch.exp(-(d * d) * inv_2sr2)  # RangeGauss, :157-161
            taps.append((j, i, ry, rx, sgauss * rgauss))
    return taps


def _make_sampler(coarse: torch.Tensor, fine_shape):
    """fn(j, i, ry, rx) -> coarse values on the fine grid; `coarse` may
    carry trailing channel axes."""
    H, W = fine_shape
    Hc, Wc = coarse.shape[:2]
    channels = tuple(coarse.shape[2:])
    if H % Hc == 0 and W % Wc == 0 and H // Hc == W // Wc:
        s = H // Hc
        up = torch.repeat_interleave(
            torch.repeat_interleave(coarse, s, dim=0), s, dim=1)
        x, y = geo.pixel_grid(H, W, device=coarse.device)
        ry_res = y.long() % s
        rx_res = x.long() % s

        def sample(j, i, ry, rx):
            # value(y, x) = coarse[clip(by + j), clip(bx + i)]; within the
            # residue class (ry0, rx0) that is the edge-clamped shift of
            # `up` by (s*j - ry0, s*i - rx0): up's outer s-1 rows / columns
            # repeat the coarse border, so fine-edge clamping equals
            # coarse-index clamping
            out = torch.zeros((H, W) + channels, dtype=coarse.dtype,
                              device=coarse.device)
            for ry0 in range(s):
                for rx0 in range(s):
                    shifted = _shift_edge(up, s * j - ry0, s * i - rx0)
                    m = (ry_res == ry0) & (rx_res == rx0)
                    out = torch.where(m[(...,) + (None,) * len(channels)],
                                      shifted, out)
            return out

        return sample

    flat = coarse.reshape((-1,) + channels)

    def sample_gather(j, i, ry, rx):
        return flat[(ry * Wc + rx).reshape(-1)].reshape((H, W) + channels)

    return sample_gather


def jbu_depth(fine_gray: torch.Tensor, coarse_depth: torch.Tensor,
              params: PatchMatchParams) -> torch.Tensor:
    """Upsample `coarse_depth` [Hc, Wc] to `fine_gray`'s [H, W] grid."""
    H, W = fine_gray.shape
    nn, scale = _window((H, W), coarse_depth.shape)
    sample = _make_sampler(coarse_depth, (H, W))
    num = torch.zeros((H, W), dtype=torch.float32, device=fine_gray.device)
    den = torch.zeros_like(num)
    for j, i, ry, rx, w in _weights(fine_gray, coarse_depth.shape, nn, scale,
                                    params):
        num = num + sample(j, i, ry, rx) * w
        den = den + w
    return num / torch.clamp(den, min=1e-30)


def jbu_normal_cost(fine_gray: torch.Tensor, coarse_normal: torch.Tensor,
                    coarse_cost: torch.Tensor, params: PatchMatchParams):
    """Hierarchy-init upscale of (normal, cost) (upscale_normal,
    ACMMP.cu:548-607). Returns (normal [H, W, 3] normalised, cost [H, W])."""
    H, W = fine_gray.shape
    nn, scale = _window((H, W), coarse_cost.shape)
    sample_n = _make_sampler(coarse_normal, (H, W))
    sample_c = _make_sampler(coarse_cost, (H, W))
    dev = fine_gray.device
    n_acc = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    c_acc = torch.zeros((H, W), dtype=torch.float32, device=dev)
    den = torch.zeros_like(c_acc)
    for j, i, ry, rx, w in _weights(fine_gray, coarse_cost.shape, nn, scale,
                                    params):
        n_acc = n_acc + sample_n(j, i, ry, rx) * w[..., None]
        c_acc = c_acc + sample_c(j, i, ry, rx) * w
        den = den + w
    normal = n_acc / torch.clamp(den, min=1e-30)[..., None]
    normal = normal / torch.clamp(
        torch.linalg.vector_norm(normal, dim=-1, keepdim=True), min=1e-12)
    return normal, c_acc / torch.clamp(den, min=1e-30)
