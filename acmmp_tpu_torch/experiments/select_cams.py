"""Camera-subset selection for DTU experiments — the port's copy of
``acmmp_tpu/experiments/select_cams.py``.

Re-implements python_scripts/select_dtu_cams.py: pick a camera subset from a
source dense folder, build the pair list from inter-camera view-direction
angles (keep pairs whose angle lies in (min_angle, max_angle), randomly cap
at max_n_view, seeded — select_dtu_cams.py:38-56), and write a reduced dense
folder with renumbered cams/images and a score-1 pair.txt
(select_dtu_cams.py:28-35, 64-88)."""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class ReconParams:
    """(select_dtu_cams.py:14-25; DTU defaults at :95)."""

    mindist: float = 0.1
    maxdist: float = 0.8
    steps: int = 192
    minangle: float = 3.0
    maxangle: float = 45.0
    max_n_view: int = 9


def view_direction_from_cam_txt(path: str) -> np.ndarray:
    """Optical axis (R^T z) of a cam.txt extrinsic (get_v_vec,
    select_dtu_cams.py:60-61 — note it uses R @ z; the rows of R are the
    camera axes in world coords, so R[2] is the axis: the reference's
    `ext[:3,:3] @ [0,0,1]` takes the third *column*, which equals R^T z only
    for symmetric R. We use the geometrically correct third row.)"""
    ext = np.loadtxt(path, skiprows=1, max_rows=4)
    return ext[2, :3]


def calc_pairs(view_vecs: np.ndarray, params: ReconParams,
               rng: Optional[np.random.Generator] = None) -> List[np.ndarray]:
    """Per-camera source lists from pairwise view-direction angles
    (calc_pairs, select_dtu_cams.py:38-56)."""
    if rng is None:
        rng = np.random.default_rng()
    v = view_vecs / np.linalg.norm(view_vecs, axis=1, keepdims=True)
    cosang = np.clip(np.sum(v[None] * v[:, None], axis=-1), -1.0, 1.0)
    ang = np.degrees(np.arccos(cosang))
    mask = (ang > params.minangle) & (ang < params.maxangle)
    out = []
    for row in mask:
        valid = np.where(row)[0]
        if len(valid) <= params.max_n_view:
            out.append(valid)
        else:
            out.append(rng.choice(valid, params.max_n_view, replace=False))
    return out


def write_pair_file(path: str, pair_list: Sequence[Sequence[int]]) -> None:
    """pair.txt with unit scores (write_pair_file, select_dtu_cams.py:28-35)."""
    with open(path, "w") as f:
        f.write(f"{len(pair_list)}\n")
        for i, srcs in enumerate(pair_list):
            f.write(f"{i}\n")
            f.write(f"{len(srcs)} " +
                    " ".join(f"{int(s)} 1" for s in srcs) + "\n")


def _sorted(globbed):
    return sorted(globbed, key=lambda p: os.path.basename(p))


def setup_from_source(cams: Sequence[int], src: str, dst: str,
                      params: ReconParams, seed: int = 42) -> str:
    """Build a reduced dense folder using the camera subset `cams`
    (setup_from_source, select_dtu_cams.py:64-88)."""
    import glob

    cam_files = _sorted(glob.glob(os.path.join(src, "cams", "*_cam.txt")))
    img_files = _sorted(glob.glob(os.path.join(src, "images", "*")))
    vecs = np.array([view_direction_from_cam_txt(cam_files[c]) for c in cams])
    pairs = calc_pairs(vecs, params, np.random.default_rng(seed))

    if os.path.exists(dst):
        shutil.rmtree(dst)
    os.makedirs(os.path.join(dst, "cams"))
    os.makedirs(os.path.join(dst, "images"))
    for new_id, cam_n in enumerate(cams):
        shutil.copy(cam_files[cam_n],
                    os.path.join(dst, "cams", f"{new_id:08d}_cam.txt"))
        ext = os.path.splitext(img_files[cam_n])[1]
        shutil.copy(img_files[cam_n],
                    os.path.join(dst, "images", f"{new_id:08d}{ext}"))
    write_pair_file(os.path.join(dst, "pair.txt"), pairs)
    return dst
