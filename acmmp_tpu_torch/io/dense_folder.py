"""The on-disk *dense folder* contract shared with the reference — the
port's copy of ``acmmp_tpu/io/dense_folder.py``:

    <dense>/images/%08d.jpg      grayscale-convertible images
    <dense>/cams/%08d_cam.txt    extrinsic 4x4, intrinsic 3x3, depth range
    <dense>/pair.txt             view graph with match scores
    <out>/2333_%08d/{depths,depths_geom,normals,costs}.dmb   stage checkpoints

cam.txt parsing mirrors ReadCamera (src/ACMMP.cpp:154-179); pair.txt
mirrors GenerateSampleList (src/acmmp_definitions.cpp:179-205).

``resize_image`` runs the JAX package's native bilinear formula
(``an_resize_bilinear_f32`` / ``_u8``) from the port's own copy of its
source, ``csrc/host_resize.cpp``, built with that library's compiler and
flags at first use (kernels/_build.py::load_host), so both packages
rescale an image to the same bits on any host, also where g++ contracts
the 4-term sum into FMAs. A build failure raises. ``resize_image_plain``
is the same formula vectorised in numpy (f64 source coordinates, f32
weights, every product rounded), on no path: it equals the library where
the compiler does not contract. (The JAX package's PIL fallback gives
other values.)
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import os
from typing import List, Sequence, Tuple

import numpy as np
from PIL import Image as PILImage

from acmmp_tpu_torch.core.geometry import Camera
from acmmp_tpu_torch.kernels import _build


@dataclasses.dataclass
class Problem:
    """One reference view and its scored source views
    (struct Problem, src/acmmp_definitions.h:57-63)."""

    ref_image_id: int
    src_image_ids: List[int]
    max_image_size: int = 6400
    num_downscale: int = 0
    cur_image_size: int = 6400


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


def image_path(dense_folder: str, image_id: int,
               image_dir: str = "images") -> str:
    return os.path.join(dense_folder, image_dir, f"{image_id:08d}.jpg")


def cam_path(dense_folder: str, image_id: int) -> str:
    return os.path.join(dense_folder, "cams", f"{image_id:08d}_cam.txt")


def result_dir(output_folder: str, image_id: int) -> str:
    """Per-view checkpoint directory, keeping the reference's `2333_`
    prefix (acmmp_definitions.cpp:254-256) so runs are cross-checkable."""
    return os.path.join(output_folder, f"2333_{image_id:08d}")


def read_cam_txt(path) -> NumpyCamera:
    with open(path) as f:
        tokens = f.read().split()
    # layout: "extrinsic" 16 floats "intrinsic" 9 floats depth_min
    # interval [num max]
    if tokens[0] != "extrinsic":
        raise ValueError(f"{path}: expected 'extrinsic' header")
    ext = np.array([float(v) for v in tokens[1:17]],
                   dtype=np.float64).reshape(4, 4)
    if tokens[17] != "intrinsic":
        raise ValueError(f"{path}: expected 'intrinsic' header")
    K = np.array([float(v) for v in tokens[18:27]],
                 dtype=np.float64).reshape(3, 3)
    depth_tokens = [float(v) for v in tokens[27:31]]
    depth_min = depth_tokens[0]
    if len(depth_tokens) >= 4:
        depth_max = depth_tokens[3]
    elif len(depth_tokens) == 3:
        # MVSNet-style (min, interval, num): derive max
        depth_max = depth_tokens[0] + depth_tokens[1] * (depth_tokens[2] - 1)
    else:
        raise ValueError(f"{path}: missing depth range")
    return NumpyCamera(
        K=K.astype(np.float32),
        R=ext[:3, :3].astype(np.float32),
        t=ext[:3, 3].astype(np.float32),
        depth_min=float(depth_min),
        depth_max=float(depth_max),
    )


def write_cam_txt(path, cam: NumpyCamera, depth_interval: float = 0.0,
                  depth_num: float = 192.0) -> None:
    ext = np.eye(4, dtype=np.float64)
    ext[:3, :3] = cam.R
    ext[:3, 3] = cam.t
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for row in ext:
            f.write(" ".join(repr(float(v)) for v in row) + " \n")
        f.write("\nintrinsic\n")
        for row in np.asarray(cam.K, dtype=np.float64):
            f.write(" ".join(repr(float(v)) for v in row) + " \n")
        f.write("\n%f %f %f %f\n" % (cam.depth_min, depth_interval,
                                     depth_num, cam.depth_max))


def load_cams(dense_folder: str) -> List[NumpyCamera]:
    """The folder's cameras in id order, each with the size of its image
    %08d.* in images/, whatever extension it carries (DTU scans are
    commonly .png, synthetic folders .jpg)."""
    cam_files = sorted(
        glob.glob(os.path.join(dense_folder, "cams", "*_cam.txt")))
    cams = []
    for i, cf in enumerate(cam_files):
        cam = read_cam_txt(cf)
        matches = glob.glob(os.path.join(dense_folder, "images", f"{i:08d}.*"))
        if not matches:
            raise FileNotFoundError(
                f"no image {i:08d}.* in {dense_folder}/images")
        with PILImage.open(matches[0]) as im:
            cam.width, cam.height = im.size
        cams.append(cam)
    return cams


def read_pair_txt(path) -> List[Problem]:
    """Parse pair.txt; source views with score <= 0 are dropped
    (GenerateSampleList, acmmp_definitions.cpp:194-201)."""
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)
    num_images = int(next(it))
    problems = []
    for _ in range(num_images):
        ref_id = int(next(it))
        n_src = int(next(it))
        src_ids = []
        for _ in range(n_src):
            sid = int(next(it))
            score = float(next(it))
            if score <= 0.0:
                continue
            src_ids.append(sid)
        problems.append(Problem(ref_image_id=ref_id, src_image_ids=src_ids))
    return problems


def write_pair_txt(path, pairs: Sequence[Tuple[int, Sequence[Tuple[int, float]]]]
                   ) -> None:
    """pairs: [(ref_id, [(src_id, score), ...]), ...]."""
    with open(path, "w") as f:
        f.write(f"{len(pairs)}\n")
        for ref_id, scored in pairs:
            f.write(f"{ref_id}\n{len(scored)} ")
            for sid, score in scored:
                f.write(f"{sid} {score:g} ")
            f.write("\n")


def load_image_gray(path) -> np.ndarray:
    """Grayscale float32 image in [0, 255] (matches cv::IMREAD_GRAYSCALE +
    convertTo CV_32FC1, ACMMP.cpp:539-541)."""
    img = PILImage.open(path).convert("L")
    return np.asarray(img, dtype=np.float32)


def load_image_color(path) -> np.ndarray:
    """RGB uint8 image (the reference loads BGR; we keep RGB end to end)."""
    img = PILImage.open(path).convert("RGB")
    return np.asarray(img, dtype=np.uint8)


def _resize_axis(n_src: int, n_dst: int):
    """Source indices (i0, i1) and f32 weights of the second one along one
    axis: OpenCV's half-pixel convention, clamped to the edge, the
    coordinate in f64 (the native library's per-row / per-column terms)."""
    s = float(n_src) / n_dst
    f = (np.arange(n_dst, dtype=np.float64) + 0.5) * s - 0.5
    f = np.minimum(np.maximum(f, 0.0), float(n_src - 1))
    i0 = f.astype(np.int64)
    i1 = np.minimum(i0 + 1, n_src - 1)
    return i0, i1, (f - i0).astype(np.float32)


def resize_image(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """Bilinear resize with OpenCV's half-pixel convention (the reference
    uses cv::resize INTER_LINEAR, ACMMP.cpp:187-190); f32 or u8, 2D or 3D
    (channels last), through csrc/host_resize.cpp. u8 in gives u8 out,
    rounded as v + 0.5 truncated; anything else is computed and returned
    as f32."""
    if img.ndim not in (2, 3):
        raise ValueError(f"resize_image: a 2D or 3D image, not {img.shape}")
    lib = _build.load_host("host_resize")
    is_u8 = img.dtype == np.uint8
    fn = lib.an_resize_bilinear_u8 if is_u8 else lib.an_resize_bilinear_f32
    fn.restype = None
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                   ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                   ctypes.c_int32]
    src = np.ascontiguousarray(img, np.uint8 if is_u8 else np.float32)
    dst = np.empty((new_h, new_w) + img.shape[2:], src.dtype)
    fn(src.ctypes.data, img.shape[0], img.shape[1], dst.ctypes.data,
       new_h, new_w, 1 if img.ndim == 2 else img.shape[2])
    return dst


def resize_image_plain(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """resize_image's formula in numpy, every product rounded: the plain
    version of csrc/host_resize.cpp, on no path."""
    y0, y1, wy = _resize_axis(img.shape[0], new_h)
    x0, x1, wx = _resize_axis(img.shape[1], new_w)
    is_u8 = img.dtype == np.uint8
    src = np.asarray(img, np.float32)
    extra = (None,) * (src.ndim - 2)
    wy = wy[(slice(None), None) + extra]
    wx = wx[(None, slice(None)) + extra]
    one = np.float32(1.0)
    rows0, rows1 = src[y0], src[y1]
    out = (rows0[:, x0] * (one - wx) * (one - wy)
           + rows0[:, x1] * wx * (one - wy)
           + rows1[:, x0] * (one - wx) * wy
           + rows1[:, x1] * wx * wy)
    if is_u8:
        return (out + np.float32(0.5)).astype(np.uint8)
    return out


def rescale_to_max_size(img: np.ndarray, cam: NumpyCamera, max_size: int):
    """Cap the longer image side at max_size, rescaling intrinsics
    (InputInitialization, ACMMP.cpp:566-598)."""
    rows, cols = img.shape[:2]
    if cols <= max_size and rows <= max_size:
        cam = dataclasses.replace(cam, width=cols, height=rows)
        return img, cam
    factor = min(max_size / cols, max_size / rows)
    new_cols = int(round(cols * factor))
    new_rows = int(round(rows * factor))
    scale_x = new_cols / cols
    scale_y = new_rows / rows
    out = resize_image(img, new_cols, new_rows)
    K = cam.K.copy()
    K[0, :] *= scale_x
    K[1, :] *= scale_y
    cam = dataclasses.replace(cam, K=K, width=new_cols, height=new_rows)
    return out, cam
