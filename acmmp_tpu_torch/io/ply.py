"""Binary PLY point-cloud writer/reader — the port's copy of
``acmmp_tpu/io/ply.py`` (its numpy path).

Matches the reference's output layout (StoreColorPlyFileBinaryPointCloud,
src/ACMMP.cpp:382-435): binary little-endian, per vertex x y z (f4),
nx ny nz (f4), red green blue (u1). Unlike the reference's OpenMP
critical-section writer, output ordering is deterministic.
"""

from __future__ import annotations

import numpy as np

_VERTEX_DTYPE = np.dtype(
    [
        ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
        ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
        ("red", "u1"), ("green", "u1"), ("blue", "u1"),
    ]
)


def write_ply(path, points: np.ndarray, normals: np.ndarray,
              colors: np.ndarray) -> None:
    """points/normals: (N, 3) float; colors: (N, 3) uint8 RGB."""
    points = np.asarray(points, dtype=np.float32)
    normals = np.asarray(normals, dtype=np.float32)
    colors = np.asarray(colors)
    n = points.shape[0]
    # non-finite coordinates are zeroed like the reference (ACMMP.cpp:415-419)
    bad = ~np.isfinite(points).all(axis=1)
    if bad.any():
        points = points.copy()
        points[bad] = 0.0
    rec = np.empty(n, dtype=_VERTEX_DTYPE)
    rec["x"], rec["y"], rec["z"] = points.T
    rec["nx"], rec["ny"], rec["nz"] = normals.T
    rec["red"] = colors[:, 0].astype(np.uint8)
    rec["green"] = colors[:, 1].astype(np.uint8)
    rec["blue"] = colors[:, 2].astype(np.uint8)
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float nx\nproperty float ny\nproperty float nz\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        rec.tofile(f)


def read_ply(path):
    """Read a binary-little-endian PLY with float/uchar scalar properties.
    Returns (points (N,3), normals (N,3) or None, colors (N,3) or None)."""
    with open(path, "rb") as f:
        props = []
        n = 0
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property"):
                _, typ, name = line.split()
                np_typ = {"float": "<f4", "float32": "<f4", "double": "<f8",
                          "uchar": "u1", "uint8": "u1", "int": "<i4"}[typ]
                props.append((name, np_typ))
            elif line == "end_header":
                break
            elif (line.startswith("format")
                  and "binary_little_endian" not in line):
                raise ValueError(f"{path}: unsupported ply format: {line}")
        rec = np.fromfile(f, dtype=np.dtype(props), count=n)
    pts = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float32)
    normals = None
    if "nx" in rec.dtype.names:
        normals = np.stack([rec["nx"], rec["ny"], rec["nz"]],
                           axis=1).astype(np.float32)
    colors = None
    if "red" in rec.dtype.names:
        colors = np.stack([rec["red"], rec["green"], rec["blue"]], axis=1)
    return pts, normals, colors
