"""Host-side camera record of the dense-folder contract — the port's copy
of ``NumpyCamera`` from ``acmmp_tpu/io/dense_folder.py`` (cam.txt parsing
mirrors ReadCamera, src/ACMMP.cpp:154-179)."""

from __future__ import annotations

import dataclasses

import numpy as np

from acmmp_tpu_torch.core.geometry import Camera


@dataclasses.dataclass
class NumpyCamera:
    """Host-side camera record prior to tensor conversion."""

    K: np.ndarray
    R: np.ndarray
    t: np.ndarray
    depth_min: float
    depth_max: float
    width: int = 0
    height: int = 0

    def to_torch(self, device=None) -> Camera:
        return Camera.from_numpy(
            self.K, self.R, self.t, float(self.width), float(self.height),
            self.depth_min, self.depth_max, device=device)
