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
also not reproduced).

The 3-channel 16-bit normal PNGs go through a numpy + zlib codec
(``write_png16``, ``read_png``) rather than OpenCV, which PIL cannot
replace (it has no 16-bit RGB mode). It keeps OpenCV's on-disk meaning:
channel 0 of the array is the file's blue sample and channel 2 its red,
so priors written by either package decode to the same arrays in both."""

from __future__ import annotations

import os
import struct
import zlib
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
    write_png16(npath, n16)


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> samples per pixel (grey, RGB)
_PNG_CHANNELS = {0: 1, 2: 3}


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data)))


def write_png16(path, arr: np.ndarray) -> None:
    """Write a uint16 [H, W] or [H, W, 3] array as a 16-bit PNG, as
    ``cv2.imwrite`` does: a 3-channel array is in BGR order, so channel 2
    is stored as red. Rows are written unfiltered."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint16 or arr.ndim not in (2, 3) or (
            arr.ndim == 3 and arr.shape[2] != 3):
        raise ValueError(f"write_png16: need uint16 [H, W] or [H, W, 3], "
                         f"got {arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    samples = arr[..., ::-1] if arr.ndim == 3 else arr
    rows = np.zeros((h, 1 + samples[0].size * 2), np.uint8)
    rows[:, 1:] = np.ascontiguousarray(samples, ">u2").view(
        np.uint8).reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, 16, 2 if arr.ndim == 3 else 0,
                       0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _png_chunk(b"IEND", b""))


def _unfilter_wavefront(kinds: np.ndarray, filt: np.ndarray,
                        bpp: int) -> np.ndarray:
    """Undo any mix of the five filters, one anti-diagonal of pixels at a
    time. A pixel's prediction reads only its left, upper and upper-left
    neighbours, which lie on the two diagonals before its own, so each
    diagonal is one numpy step: H + W - 1 steps in all, where the Average
    (3) and Paeth (4) filters would take one Python step per byte.

    The pixels are held skewed, (y, x) at [x + y + 1, y + 1] of `s`, so a
    diagonal is one row of `s`; the first and last rows and column 0 stay
    zero, the neighbours PNG puts outside the image."""
    h, n = filt.shape
    w = n // bpp
    ys, xs = np.indices((h, w))
    f = np.zeros((h + w, h, bpp), np.int16)
    f[xs + ys, ys] = filt.reshape(h, w, bpp)
    s = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    kind = kinds[:, None]
    sub, up, avg, paeth = (kind == k for k in (1, 2, 3, 4))
    for d in range(h + w - 1):
        y0, y1 = max(0, d - w + 1), min(h, d + 1)
        a = s[d, y0 + 1:y1 + 1]          # left
        b = s[d, y0:y1]                  # up
        c = s[d - 1, y0:y1]              # up-left (row -1 of s is zero)
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where(
            paeth[y0:y1],
            np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)),
            np.where(avg[y0:y1], (a + b) >> 1,
                     np.where(up[y0:y1], b, np.where(sub[y0:y1], a, 0))))
        pred += f[d, y0:y1]
        pred &= 0xFF
        s[d + 1, y0 + 1:y1 + 1] = pred
    return s[xs + ys + 1, ys + 1].astype(np.uint8).reshape(h, n)


def read_png(path) -> np.ndarray:
    """Decode a non-interlaced 8- or 16-bit grey or RGB PNG as
    ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` does: [H, W] for grey,
    [H, W, 3] in BGR order for RGB, uint8 or uint16."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, ihdr = 8, [], None
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth not in (8, 16) or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, "
                         f"colour type {ctype}, interlace {interlace})")
    ch = _PNG_CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(
        h, 1 + w * bpp)
    kinds = raw[:, 0]
    if kinds.max(initial=0) > 4:
        y = int(np.argmax(kinds > 4))
        raise ValueError(f"{path}: row {y} has filter type {kinds[y]}")
    if (kinds >= 3).any():
        out = _unfilter_wavefront(kinds, raw[:, 1:], bpp)
    else:
        # None, Sub and Up: each row is one numpy step
        out = np.empty((h, w * bpp), np.uint8)
        prev = np.zeros(w * bpp, np.uint8)
        for y in range(h):
            kind, line = kinds[y], raw[y, 1:]
            if kind == 0:
                cur = line
            elif kind == 1:
                cur = np.cumsum(line.reshape(w, bpp), axis=0,
                                dtype=np.uint8).reshape(-1)
            else:
                cur = line + prev
            out[y] = prev = cur
    img = out.view(">u2").astype(np.uint16) if depth == 16 else out
    img = img.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img[..., ::-1]


def load_seed_planes(dense_folder: str, image_id: int, cam: NumpyCamera,
                     rows: int, cols: int) -> Optional[np.ndarray]:
    """Read the priors for one view and convert to [rows, cols, 4] plane
    hypotheses in the reference-camera frame, subsampled by the integer
    scale between the stored prior and the current solve resolution."""
    dpath, npath = _prior_paths(dense_folder, image_id)
    if not (os.path.exists(dpath) and os.path.exists(npath)):
        return None
    depth_png = np.asarray(PILImage.open(dpath)).astype(np.float32)
    normal_png = read_png(npath).astype(np.float32)
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
