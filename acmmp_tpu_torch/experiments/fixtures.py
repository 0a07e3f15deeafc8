"""Fixture generators — the port's copy of
``acmmp_tpu/experiments/fixtures.py``, the reference's hand-built inputs,
reproducible:

  * write_synthetic_dense_folder: a complete N-camera dense folder of a
    textured plane or relief (the capability of
    python_scripts/make_alex.py:24-74, which hand-writes a 2-camera
    folder) — used for smoke tests and demos;
  * write_random_priors: random 16-bit prior PNGs for every view
    (python_scripts/make_blank_random.py:6-11) — a smoke fixture for the
    seeded-init path, written through io/priors' PNG codec (no OpenCV);
  * rewrite_depth_ranges: patch the depth range row of every cam.txt
    (python_scripts/refactor_dir.py:6-12);
  * clean_outputs: delete reconstruction outputs, keep inputs
    (python_scripts/clean_acmmp_Dirs.py).
"""

from __future__ import annotations

import glob
import os
import shutil

import numpy as np
from PIL import Image as PILImage

from acmmp_tpu_torch.io.priors import write_png16
from acmmp_tpu_torch.utils.synth import (textured_plane_scene,
                                         textured_relief_scene,
                                         write_dense_folder)


def write_synthetic_dense_folder(
    dst: str, n_views: int = 4, width: int = 64, height: int = 48,
    plane_z: float = 5.0, seed: int = 0, relief: bool = False,
) -> str:
    if relief:
        images, cams, _ = textured_relief_scene(
            n_views=n_views, width=width, height=height, base_z=plane_z,
            seed=seed)
    else:
        images, cams, _ = textured_plane_scene(
            n_views=n_views, width=width, height=height, plane_z=plane_z,
            seed=seed)
    return write_dense_folder(dst, images, cams)


def write_random_priors(dense_folder: str, seed: int = 0) -> int:
    """Random 16-bit prior PNGs matching each image's size
    (make_blank_random.py:6-11). Returns the number of views written."""
    rng = np.random.default_rng(seed)
    images = sorted(glob.glob(os.path.join(dense_folder, "images", "*")))
    ddir = os.path.join(dense_folder, "priors", "depths")
    ndir = os.path.join(dense_folder, "priors", "normals")
    os.makedirs(ddir, exist_ok=True)
    os.makedirs(ndir, exist_ok=True)
    for i, path in enumerate(images):
        with PILImage.open(path) as im:
            w, h = im.size
        d = rng.integers(0, 65536, size=(h, w), dtype=np.uint16)
        n = rng.integers(0, 65536, size=(h, w, 3), dtype=np.uint16)
        write_png16(os.path.join(ddir, f"{i:08d}.png"), d)
        write_png16(os.path.join(ndir, f"{i:08d}.png"), n)
    return len(images)


def rewrite_depth_ranges(dense_folder: str, depth_min: float,
                         depth_max: float, steps: int = 192) -> int:
    """Patch the depth-range line of every cam.txt (refactor_dir.py:6-12;
    the reference writes `min interval steps max`)."""
    cams = sorted(glob.glob(os.path.join(dense_folder, "cams", "*_cam.txt")))
    interval = (depth_max - depth_min) / max(steps, 1)
    for path in cams:
        with open(path) as f:
            lines = f.read().splitlines()
        # the depth-range line is the last non-empty line
        for i in range(len(lines) - 1, -1, -1):
            if lines[i].strip():
                lines[i] = f"{depth_min} {interval} {steps} {depth_max}"
                break
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
    return len(cams)


def clean_outputs(dense_folder: str) -> None:
    """Remove reconstruction outputs, keep images/cams/pair/priors."""
    for name in os.listdir(dense_folder):
        p = os.path.join(dense_folder, name)
        if name in ("images", "cams", "pair.txt", "priors"):
            continue
        if os.path.isdir(p):
            shutil.rmtree(p)
        elif name.endswith(".ply"):
            os.remove(p)
