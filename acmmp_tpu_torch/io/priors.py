"""Seeded prior ingestion — the port's copy of ``acmmp_tpu/io/priors.py``:
16-bit PNG depth/normal priors -> per-pixel plane hypotheses (pSampler,
src/acmmp_definitions.cpp:8-177).

Encoding (GetPriorPlaneEstimate, acmmp_definitions.cpp:117-129):
  depth  = png * (depth_max - depth_min) / 65535 + depth_min
  normal = png * 2 / 65536 - 1
Normals are flipped to face the camera and renormalized (the reference's
normVec3 multiplies by the norm instead of dividing,
acmmp_definitions.cpp:35-42 — a bug we do not reproduce), then converted to
plane 4-vectors. The camera passed in must be the *reference* camera of
the view (the reference passes cameras[idx], an arbitrary source camera —
also not reproduced)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
from PIL import Image as PILImage

from acmmp_tpu_torch.io.dense_folder import NumpyCamera


def _prior_paths(dense_folder: str, image_id: int):
    return (os.path.join(dense_folder, "priors", "depths",
                         f"{image_id:08d}.png"),
            os.path.join(dense_folder, "priors", "normals",
                         f"{image_id:08d}.png"))


def priors_available(dense_folder: str, num_images: int) -> bool:
    """Detect the priors/{depths,normals}/%08d.png contract by probing the
    final image (pSampler ctor, acmmp_definitions.cpp:15-28)."""
    return all(os.path.exists(p)
               for p in _prior_paths(dense_folder, num_images - 1))


def write_prior_pngs(dense_folder: str, image_id: int, depth: np.ndarray,
                     normal: np.ndarray, depth_min: float, depth_max: float):
    """Inverse of the encoding, for harnesses that bootstrap priors."""
    dpath, npath = _prior_paths(dense_folder, image_id)
    os.makedirs(os.path.dirname(dpath), exist_ok=True)
    os.makedirs(os.path.dirname(npath), exist_ok=True)
    rng = max(depth_max - depth_min, 1e-12)
    d16 = np.clip((depth - depth_min) / rng * 65535.0, 0,
                  65535).astype(np.uint16)
    n16 = np.clip((normal + 1.0) * 65536.0 / 2.0, 0, 65535).astype(np.uint16)
    PILImage.fromarray(d16).save(dpath)
    # 3-channel 16-bit normals need cv2 (PIL has no 16-bit RGB)
    import cv2

    cv2.imwrite(npath, n16)


def _read_png16_color(path) -> np.ndarray:
    import cv2

    arr = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if arr is None:
        raise FileNotFoundError(path)
    return arr.astype(np.float32)


def load_seed_planes(dense_folder: str, image_id: int, cam: NumpyCamera,
                     rows: int, cols: int) -> Optional[np.ndarray]:
    """Read the priors for one view and convert to [rows, cols, 4] plane
    hypotheses in the reference-camera frame, subsampled by the integer
    scale between the stored prior and the current solve resolution."""
    dpath, npath = _prior_paths(dense_folder, image_id)
    if not (os.path.exists(dpath) and os.path.exists(npath)):
        return None
    depth_png = np.asarray(PILImage.open(dpath)).astype(np.float32)
    normal_png = _read_png16_color(npath)
    if normal_png.ndim != 3:
        raise ValueError(f"{npath}: expected 3-channel normal prior")
    depth = depth_png * (cam.depth_max - cam.depth_min) / 65535.0 \
        + cam.depth_min
    normal = normal_png * 2.0 / 65536.0 - 1.0

    scale = max(depth.shape[0] // rows, 1)
    depth = depth[::scale, ::scale][:rows, :cols]
    normal = normal[::scale, ::scale][:rows, :cols]

    fx, fy = cam.K[0, 0], cam.K[1, 1]
    cx, cy = cam.K[0, 2], cam.K[1, 2]
    xs, ys = np.meshgrid(np.arange(cols, dtype=np.float32),
                         np.arange(rows, dtype=np.float32))
    X = np.stack([depth * (xs - cx) / fx, depth * (ys - cy) / fy, depth], -1)
    vd = X / np.maximum(np.linalg.norm(X, axis=-1, keepdims=True), 1e-12)
    flip = np.sum(normal * vd, axis=-1, keepdims=True) > 0
    normal = np.where(flip, -normal, normal)
    normal = normal / np.maximum(
        np.linalg.norm(normal, axis=-1, keepdims=True), 1e-12)
    w = -np.sum(normal * X, axis=-1)
    return np.concatenate([normal, w[..., None]], axis=-1).astype(np.float32)
