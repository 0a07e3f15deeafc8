"""[The benchmark's plain reference: a frozen copy of the program's
`acmmp_tpu_torch/ops/parity.py`, its plain (non-kernel) path only, importing
nothing of the program. Its original text follows.]

Checkerboard parity row-packing — the port of ``acmmp_tpu/ops/parity.py``.

Each red/black half-sweep updates the pixels of one parity only, so the
sweep scores its hypotheses on a half-height grid: packed (i, j) holds the
full-grid pixel at local row ``2*i + (off0 + j) % 2``, column ``j``. Here
``off0`` is a host int (the sweep's parity is known on the host)."""

from __future__ import annotations

import torch


def row_pack_offset(parity_mask: torch.Tensor) -> int:
    """off0 for a [H, W] bool checkerboard mask of the active parity:
    0 if local (0, 0) is active, else 1."""
    return 0 if bool(parity_mask[0, 0]) else 1


def pack_rows(arr: torch.Tensor, off0: int) -> torch.Tensor:
    """[..., H, W] -> [..., H//2, W] keeping only active-parity pixels."""
    H, W = arr.shape[-2:]
    a = arr.reshape(arr.shape[:-2] + (H // 2, 2, W))
    offj = (off0 + torch.arange(W, device=arr.device)) % 2       # [W]
    return torch.where(offj == 0, a[..., 0, :], a[..., 1, :])


def pack_rows_c(arr: torch.Tensor, off0: int) -> torch.Tensor:
    """[..., H, W, C] -> [..., H//2, W, C] (channel-last fields)."""
    return torch.movedim(pack_rows(torch.movedim(arr, -1, 0), off0), 0, -1)


def unpack_rows(packed: torch.Tensor) -> torch.Tensor:
    """[..., H2, W] -> [..., 2*H2, W] by row-pair duplication; combine with
    a parity-mask `where` to scatter back into the full grid."""
    return torch.repeat_interleave(packed, 2, dim=-2)


def unpack_rows_c(packed: torch.Tensor) -> torch.Tensor:
    """[..., H2, W, C] -> [..., 2*H2, W, C]."""
    return torch.repeat_interleave(packed, 2, dim=-3)
