"""COLMAP sparse-model ingestion — the port's copy of
``acmmp_tpu/io/colmap.py`` (host numpy): build the dense-folder contract
(cams/%08d_cam.txt, pair.txt, images/%08d.jpg) from a COLMAP
reconstruction.

Re-designs python_scripts/colmap2mvsnet_acm.py (behavior, not code): the
same outputs — per-image depth ranges from the sparse points (1%/99%
quantiles relaxed x0.75/x1.25, colmap2mvsnet_acm.py:366-396), pairwise
view-selection scores (shared-point counts, zeroed when the 75th-percentile
triangulation angle is under 1 degree, :280-302), inverse-depth step count
(:380-393) — but the O(N^2 * points) scoring is vectorized with incidence
sets instead of a multiprocessing pool.

The COLMAP file formats parsed here are the public, documented formats
(colmap.github.io/format.html)."""

from __future__ import annotations

import os
import shutil
import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np

from acmmp_tpu_torch.io.dense_folder import (NumpyCamera, write_cam_txt,
                                             write_pair_txt)

# camera model id -> (name, num_params)
_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}

# parameter layout per model: which entries give fx, fy, cx, cy
_FOCAL_LAYOUT = {
    "SIMPLE_PINHOLE": ("f", "f", 1, 2),
    "PINHOLE": (0, 1, 2, 3),
    "SIMPLE_RADIAL": ("f", "f", 1, 2),
    "SIMPLE_RADIAL_FISHEYE": ("f", "f", 1, 2),
    "RADIAL": ("f", "f", 1, 2),
    "RADIAL_FISHEYE": ("f", "f", 1, 2),
    "OPENCV": (0, 1, 2, 3),
    "OPENCV_FISHEYE": (0, 1, 2, 3),
    "FULL_OPENCV": (0, 1, 2, 3),
    "FOV": (0, 1, 2, 3),
    "THIN_PRISM_FISHEYE": (0, 1, 2, 3),
}


@dataclass
class ColmapCamera:
    model: str
    width: int
    height: int
    params: np.ndarray

    def intrinsics(self) -> np.ndarray:
        layout = _FOCAL_LAYOUT[self.model]
        p = self.params
        fx = p[0] if layout[0] == "f" else p[layout[0]]
        fy = p[0] if layout[1] == "f" else p[layout[1]]
        cx, cy = p[layout[2]], p[layout[3]]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


@dataclass
class ColmapImage:
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    point3D_ids: np.ndarray


@dataclass
class ColmapPoint:
    xyz: np.ndarray


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z), w >= 0."""
    t = np.trace(R)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        q = np.array([0.25 / s, (R[2, 1] - R[1, 2]) * s,
                      (R[0, 2] - R[2, 0]) * s, (R[1, 0] - R[0, 1]) * s])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k])
        q = np.zeros(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    return q if q[0] >= 0 else -q


# ---------------------------------------------------------------------------
# parsing (text + binary)
# ---------------------------------------------------------------------------

def _read_cameras_text(path) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cams[int(el[0])] = ColmapCamera(
                model=el[1], width=int(el[2]), height=int(el[3]),
                params=np.array([float(v) for v in el[4:]]))
    return cams


def _read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cid, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            name, np_ = _CAMERA_MODELS[model_id]
            params = struct.unpack(f"<{np_}d", f.read(8 * np_))
            cams[cid] = ColmapCamera(model=name, width=w, height=h,
                                     params=np.array(params))
    return cams


def _read_images_text(path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    for meta, pts in zip(lines[0::2], lines[1::2]):
        el = meta.split()
        pel = pts.split()
        images[int(el[0])] = ColmapImage(
            qvec=np.array([float(v) for v in el[1:5]]),
            tvec=np.array([float(v) for v in el[5:8]]),
            camera_id=int(el[8]), name=el[9],
            point3D_ids=np.array([int(v) for v in pel[2::3]], np.int64))
    return images


def _read_images_binary(path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            iid, qw, qx, qy, qz, tx, ty, tz, cid = struct.unpack(
                "<idddddddi", f.read(64))
            name = b""
            ch = f.read(1)
            while ch != b"\x00":
                name += ch
                ch = f.read(1)
            (npts,) = struct.unpack("<Q", f.read(8))
            data = struct.unpack(f"<{'ddq' * npts}", f.read(24 * npts))
            images[iid] = ColmapImage(
                qvec=np.array([qw, qx, qy, qz]), tvec=np.array([tx, ty, tz]),
                camera_id=cid, name=name.decode(),
                point3D_ids=np.array(data[2::3], np.int64))
    return images


def _read_points_text(path) -> Dict[int, ColmapPoint]:
    pts = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            pts[int(el[0])] = ColmapPoint(
                xyz=np.array([float(v) for v in el[1:4]]))
    return pts


def _read_points_binary(path) -> Dict[int, ColmapPoint]:
    pts = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            pid, x, y, z, r, g, b, err = struct.unpack("<QdddBBBd", f.read(43))
            (tl,) = struct.unpack("<Q", f.read(8))
            f.read(8 * tl)
            pts[pid] = ColmapPoint(xyz=np.array([x, y, z]))
    return pts


def read_model(path: str, ext: str = ".txt"):
    rd = {
        ".txt": (_read_cameras_text, _read_images_text, _read_points_text),
        ".bin": (_read_cameras_binary, _read_images_binary, _read_points_binary),
    }[ext]
    cameras = rd[0](os.path.join(path, "cameras" + ext))
    images = rd[1](os.path.join(path, "images" + ext))
    points = rd[2](os.path.join(path, "points3D" + ext))
    return cameras, images, points


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------

def view_selection_scores(images: Dict[int, ColmapImage],
                          points: Dict[int, ColmapPoint],
                          extrinsics: Dict[int, np.ndarray]) -> np.ndarray:
    """Pairwise shared-point counts with the low-parallax zeroing rule
    (calc_score, colmap2mvsnet_acm.py:280-302: score(i,j) = |shared 3D
    points|, zeroed when the 75th-percentile triangulation angle < 1 deg).

    Vectorized point-track formulation (the reference throws a
    multiprocessing pool at an O(N^2) pair loop, :405-410): one normalized
    viewing direction per (image, point) observation, then every
    co-observation pair of every track is scored in one flat numpy pass.
    """
    ids = sorted(images.keys())
    n = len(ids)
    centers = np.stack([
        -extrinsics[iid][:3, :3].T @ extrinsics[iid][:3, 3] for iid in ids])
    pid2dense = {pid: d for d, pid in enumerate(sorted(points.keys()))}
    xyz = np.stack([points[pid].xyz for pid in sorted(points.keys())]) \
        if points else np.zeros((0, 3))

    # flat (image, point) observation list, deduped per image
    obs_img, obs_pt = [], []
    for k, iid in enumerate(ids):
        pts_k = {pid2dense[int(p)] for p in images[iid].point3D_ids
                 if p != -1 and int(p) in pid2dense}
        obs_img.extend([k] * len(pts_k))
        obs_pt.extend(pts_k)
    score = np.zeros((n, n))
    if not obs_pt:
        return score
    obs_img = np.asarray(obs_img, np.int64)
    obs_pt = np.asarray(obs_pt, np.int64)
    order = np.argsort(obs_pt, kind="stable")
    obs_img, obs_pt = obs_img[order], obs_pt[order]
    d = centers[obs_img] - xyz[obs_pt]
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)

    # per-track co-observation pairs, generated per unique track length
    upt, starts, tlen = np.unique(obs_pt, return_index=True,
                                  return_counts=True)
    pair_i, pair_j, pair_cos = [], [], []
    for t in np.unique(tlen):
        if t < 2:
            continue
        seg = starts[tlen == t]                      # [S] segment starts
        la, lb = np.triu_indices(int(t), 1)          # [C] local combos
        ga = (seg[:, None] + la[None, :]).ravel()    # [S*C] global obs idx
        gb = (seg[:, None] + lb[None, :]).ravel()
        pair_i.append(obs_img[ga])
        pair_j.append(obs_img[gb])
        pair_cos.append(np.sum(d[ga] * d[gb], axis=1))
    if not pair_i:
        return score
    ii = np.concatenate(pair_i)
    jj = np.concatenate(pair_j)
    theta = np.degrees(np.arccos(np.clip(np.concatenate(pair_cos), -1, 1)))
    a, b = np.minimum(ii, jj), np.maximum(ii, jj)
    key = a * n + b

    # per-pair count and the reference's t75 = sorted(theta)[int(len*0.75)]
    order = np.lexsort((theta, key))
    key_s, theta_s = key[order], theta[order]
    kstarts = np.flatnonzero(np.r_[True, key_s[1:] != key_s[:-1]])
    kcounts = np.diff(np.r_[kstarts, len(key_s)])
    t75 = theta_s[kstarts + (kcounts * 3) // 4]
    s = np.where(t75 < 1.0, 0.0, kcounts.astype(np.float64))
    ka, kb = key_s[kstarts] // n, key_s[kstarts] % n
    score[ka, kb] = s
    score[kb, ka] = s
    return score


def convert_colmap(dense_folder: str, save_folder: str, max_d: int = 192,
                   interval_scale: float = 1.0, model_ext: str = ".txt",
                   num_view: int = 20) -> None:
    """COLMAP model at <dense_folder>/sparse + images at
    <dense_folder>/images -> dense-folder contract in <save_folder>."""
    image_dir = os.path.join(dense_folder, "images")
    model_dir = os.path.join(dense_folder, "sparse")
    cam_dir = os.path.join(save_folder, "cams")
    out_img_dir = os.path.join(save_folder, "images")
    os.makedirs(cam_dir, exist_ok=True)
    os.makedirs(out_img_dir, exist_ok=True)

    cameras, images, points = read_model(model_dir, model_ext)
    ids = sorted(images.keys())
    n = len(ids)

    extrinsics = {}
    for iid in ids:
        e = np.eye(4)
        e[:3, :3] = qvec2rotmat(images[iid].qvec)
        e[:3, 3] = images[iid].tvec
        extrinsics[iid] = e

    # depth ranges from the sparse cloud
    depth_ranges = {}
    for iid in ids:
        img = images[iid]
        pids = [int(p) for p in img.point3D_ids if p != -1 and int(p) in points]
        if pids:
            P = np.stack([points[p].xyz for p in pids])
            z = (extrinsics[iid][:3, :3] @ P.T + extrinsics[iid][:3, 3:4])[2]
            zs = np.sort(z)
            depth_min = zs[int(len(zs) * 0.01)] * 0.75
            depth_max = zs[int(len(zs) * 0.99)] * 1.25
        else:
            depth_min, depth_max = 0.1, 100.0
        K = cameras[img.camera_id].intrinsics()
        if max_d == 0:
            # inverse-depth step count from one-pixel baseline displacement
            R = extrinsics[iid][:3, :3]
            t = extrinsics[iid][:3, 3]
            p1 = np.array([K[0, 2], K[1, 2], 1.0])
            p2 = np.array([K[0, 2] + 1.0, K[1, 2], 1.0])
            P1 = np.linalg.inv(R) @ (np.linalg.inv(K) @ p1 * depth_min - t)
            P2 = np.linalg.inv(R) @ (np.linalg.inv(K) @ p2 * depth_min - t)
            depth_num = (1 / depth_min - 1 / depth_max) / (
                1 / depth_min - 1 / (depth_min + np.linalg.norm(P2 - P1)))
        else:
            depth_num = max_d
        interval = (depth_max - depth_min) / (depth_num - 1) / interval_scale
        depth_ranges[iid] = (depth_min, interval, depth_num, depth_max)

    score = view_selection_scores(images, points, extrinsics)

    for k, iid in enumerate(ids):
        img = images[iid]
        cam = NumpyCamera(
            K=cameras[img.camera_id].intrinsics().astype(np.float32),
            R=extrinsics[iid][:3, :3].astype(np.float32),
            t=extrinsics[iid][:3, 3].astype(np.float32),
            depth_min=float(depth_ranges[iid][0]),
            depth_max=float(depth_ranges[iid][3]),
        )
        write_cam_txt(os.path.join(cam_dir, f"{k:08d}_cam.txt"), cam,
                      depth_interval=float(depth_ranges[iid][1]),
                      depth_num=float(depth_ranges[iid][2]))

    nv = min(num_view, n - 1)
    pairs = []
    for k in range(n):
        order = np.argsort(score[k])[::-1][:nv]
        pairs.append((k, [(int(j), float(score[k, j])) for j in order]))
    write_pair_txt(os.path.join(save_folder, "pair.txt"), pairs)

    from PIL import Image as PILImage

    for k, iid in enumerate(ids):
        src = os.path.join(image_dir, images[iid].name)
        dst = os.path.join(out_img_dir, f"{k:08d}.jpg")
        if src.endswith(".jpg"):
            if os.path.abspath(src) != os.path.abspath(dst):
                shutil.copyfile(src, dst)
        else:
            PILImage.open(src).convert("RGB").save(dst, quality=95)
