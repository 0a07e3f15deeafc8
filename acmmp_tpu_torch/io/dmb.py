"""DMB container I/O — the port's copy of ``acmmp_tpu/io/dmb.py`` (its
numpy path), byte-compatible with the reference so outputs can be
cross-checked and pipelines resumed interchangeably.

Format (readDepthDmb/writeDepthDmb, src/ACMMP.cpp:264-380): four
little-endian int32 ``{type=1, h, w, nb}`` followed by ``h*w*nb`` float32
values; nb=1 for depth/cost maps, nb=3 for normal maps.
"""

from __future__ import annotations

import numpy as np

_DMB_TYPE_FLOAT = 1


def read_dmb(path) -> np.ndarray:
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype="<i4", count=4)
        if header.size != 4:
            raise ValueError(f"{path}: truncated dmb header")
        dtype_tag, h, w, nb = (int(v) for v in header)
        if dtype_tag != _DMB_TYPE_FLOAT:
            raise ValueError(f"{path}: unsupported dmb type {dtype_tag}")
        data = np.fromfile(f, dtype="<f4", count=h * w * nb)
    if data.size != h * w * nb:
        raise ValueError(f"{path}: truncated dmb payload")
    return data.reshape((h, w) if nb == 1 else (h, w, nb))


def write_dmb(path, arr: np.ndarray) -> None:
    arr = np.asarray(arr, dtype=np.float32)
    if arr.ndim == 2:
        h, w, nb = arr.shape[0], arr.shape[1], 1
    elif arr.ndim == 3:
        h, w, nb = arr.shape
    else:
        raise ValueError(f"dmb arrays are 2D or 3D, got shape {arr.shape}")
    with open(path, "wb") as f:
        np.array([_DMB_TYPE_FLOAT, h, w, nb], dtype="<i4").tofile(f)
        np.ascontiguousarray(arr, dtype="<f4").tofile(f)
