#!/usr/bin/env python3
"""The bilinear resize of both packages on this host, without JAX.

    python3 tools/torch_resize_witness.py [--flags=-mfma]

Builds the JAX package's native source (acmmp_tpu/native/src/
acmmp_native.cpp) and the port's copy of its resize
(acmmp_tpu_torch/csrc/host_resize.cpp) with g++ and that library's flags
(-O3 -fopenmp -shared -fPIC), plus `--flags` (for example -mfma, to make
g++ contract the 4-term sum into FMAs on an x86 host), into a temporary
directory, and runs both on the cases of tests/test_torch_io.py
(shapes (48, 64) and (37, 53, 3), f32 and u8, factors 0.5, 0.37 and 1.7,
seed 2). Prints the host, then per case whether the two builds agree
bitwise and on how many values the numpy formula
(io/dense_folder.resize_image_plain, every product rounded) differs from
the JAX source's build; without --flags also whether the port's shipped
resize_image agrees. Exits 1 if the two builds differ on any case."""

from __future__ import annotations

import argparse
import ctypes
import os
import platform
import shlex
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from acmmp_tpu_torch.io import dense_folder  # noqa: E402
from acmmp_tpu_torch.kernels import _build  # noqa: E402

SOURCES = {"jax": "acmmp_tpu/native/src/acmmp_native.cpp",
           "port": "acmmp_tpu_torch/csrc/host_resize.cpp"}


def _resize(lib, img, w, h):
    u8 = img.dtype == np.uint8
    fn = lib.an_resize_bilinear_u8 if u8 else lib.an_resize_bilinear_f32
    fn.restype = None
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                   ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                   ctypes.c_int32]
    src = np.ascontiguousarray(img, np.uint8 if u8 else np.float32)
    dst = np.empty((h, w) + img.shape[2:], src.dtype)
    fn(src.ctypes.data, img.shape[0], img.shape[1], dst.ctypes.data, h, w,
       1 if img.ndim == 2 else img.shape[2])
    return dst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--flags", default="",
                    help="extra g++ flags for both builds (e.g. -mfma)")
    args = ap.parse_args(argv)
    extra = shlex.split(args.flags)
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    target = subprocess.run(["g++", "-dumpmachine"], capture_output=True,
                            text=True, check=True).stdout.strip()
    print(f"host {platform.machine()}, g++ {target}: {gxx}; flags "
          f"{' '.join(_build.HOST_FLAGS + extra)}")
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, src in SOURCES.items():
            out = os.path.join(tmp, f"{name}.so")
            subprocess.run(["g++", *_build.HOST_FLAGS, *extra, "-o", out,
                            os.path.join(REPO, src)], check=True)
            libs[name] = ctypes.CDLL(out)
        differ = 0
        for dtype in (np.float32, np.uint8):
            for shape in ((48, 64), (37, 53, 3)):
                for factor in (0.5, 0.37, 1.7):
                    img = np.random.default_rng(2).uniform(
                        0, 255, shape).astype(dtype)
                    w = int(round(shape[1] * factor))
                    h = int(round(shape[0] * factor))
                    want = _resize(libs["jax"], img, w, h)
                    same = np.array_equal(_resize(libs["port"], img, w, h),
                                          want)
                    differ += not same
                    plain = int((dense_folder.resize_image_plain(img, w, h)
                                 != want).sum())
                    line = (f"{np.dtype(dtype).name} {shape} x{factor}: "
                            f"builds equal {same}; numpy formula differs "
                            f"on {plain} of {want.size}")
                    if not extra:
                        shipped = np.array_equal(
                            dense_folder.resize_image(img, w, h), want)
                        line += f"; resize_image equal {shipped}"
                    print(line)
    print(f"cases where the builds differ: {differ}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
