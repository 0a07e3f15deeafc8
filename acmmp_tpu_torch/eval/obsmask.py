"""Official DTU SampleSet observability masking for the evaluation — the
port's copy of ``acmmp_tpu/eval/obsmask.py``.

The protocol the reference invokes through MATLAB (matlab_analysis.py:24,51
-> BaseEvalMain_web.m / PointCompareMain.m) masks the two metric directions
differently:

  * accuracy: reconstruction points only count where the ground truth was
    observable — inside the scan's bounding box `BB` and where the
    voxelized `ObsMask` (stored with the margin baked into the filename,
    `ObsMask<scan>_10.mat`) is set at
    ``qv = round((p - BB[0]) / Res)``;
  * completeness: ground-truth points only count above the table plane
    `P` (`Plane<scan>.mat`): ``[p; 1] . P > 0``.

Files are plain MATLAB v5 .mat (scipy-readable). Without the SampleSet the
evaluation runs unmasked (eval/dtu.py) and is comparable only to itself —
this module makes the absolute numbers comparable to published DTU scores.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np


@dataclasses.dataclass
class DtuObsMask:
    """Loaded observability volume + optional table plane for one scan."""

    mask: np.ndarray          # [X, Y, Z] bool voxel observability
    bb: np.ndarray            # [2, 3] bounding box (min row, max row)
    res: float                # voxel size
    plane: Optional[np.ndarray] = None   # [4] table plane, or None

    @classmethod
    def load(cls, sampleset_root: str, scan_id: int,
             margin: int = 10) -> "DtuObsMask":
        """Load ObsMask<scan>_<margin>.mat (+ Plane<scan>.mat if present)
        from `<sampleset_root>/ObsMask/` (the official
        SampleSet/MVS Data/ObsMask layout)."""
        from scipy.io import loadmat

        mdir = os.path.join(sampleset_root, "ObsMask")
        mpath = os.path.join(mdir, f"ObsMask{scan_id}_{margin}.mat")
        m = loadmat(mpath)
        mask = np.asarray(m["ObsMask"]).astype(bool)
        bb = np.asarray(m["BB"], np.float64)
        res = float(np.asarray(m["Res"]).ravel()[0])
        plane = None
        ppath = os.path.join(mdir, f"Plane{scan_id}.mat")
        if os.path.exists(ppath):
            plane = np.asarray(loadmat(ppath)["P"], np.float64).ravel()
        return cls(mask=mask, bb=bb, res=res, plane=plane)

    def accuracy_mask(self, pts: np.ndarray) -> np.ndarray:
        """True for reconstruction points inside an observed voxel
        (BaseEvalMain_web.m: Qv = round((pts - BB(1,:)) / Res) + 1)."""
        pts = np.asarray(pts, np.float64)
        qv = np.round((pts - self.bb[0]) / self.res).astype(np.int64)
        shape = np.asarray(self.mask.shape)
        inb = np.all((qv >= 0) & (qv < shape), axis=1)
        ok = np.zeros(len(pts), bool)
        if inb.any():
            q = qv[inb]
            ok[inb] = self.mask[q[:, 0], q[:, 1], q[:, 2]]
        return ok

    def completeness_mask(self, gt: np.ndarray) -> np.ndarray:
        """True for ground-truth points above the table plane
        (PointCompareMain.m: [p; 1] . P > 0). All-true without a plane."""
        gt = np.asarray(gt, np.float64)
        if self.plane is None:
            return np.ones(len(gt), bool)
        return gt @ self.plane[:3] + self.plane[3] > 0
