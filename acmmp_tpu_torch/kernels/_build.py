"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface and loaded with ctypes. Pointers and the stream pass as
``c_void_p`` (Python ints from ``tensor.data_ptr()`` and
``torch.cuda.current_stream().cuda_stream``). The build runs at first use,
from the sources in the checkout, into ``build/torch_kernels/`` at the
repository root (listed in .gitignore); a library's file name carries a
hash of its source, of the headers in ``csrc/`` (``*.cuh``) and of its
flags, so an edited source or header is rebuilt.

Flags: ``-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3`` and no
``--use_fast_math`` (the kernels keep IEEE f32 arithmetic).

Host code (``csrc/<name>.cpp``, the bilinear resize) builds the same way
with ``g++`` and the JAX package's native flags (``HOST_FLAGS``), so it
contracts (or not) as that library does on the same machine. Any process
may build a library while another does: each writes a name of its own
and renames it into place."""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

HOST_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_LOG: dict = {}      # name -> nvcc's output (ptxas register report)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = cand / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _target(name: str, ext: str = "cu",
            flags=NVCC_FLAGS) -> pathlib.Path:
    src = (CSRC / f"{name}.{ext}").read_bytes()
    if ext == "cu":
        # the headers a kernel may include (csrc/*.cuh)
        src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp path, target) or
    None when the library is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def build(names) -> None:
    """Build the named kernels, one nvcc per source, all started together."""
    jobs = {n: _start(n) for n in names}
    for name, job in jobs.items():
        if job is None:
            continue
        proc, tmp, target = job
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                               f"(rc {proc.returncode}):\n{out}")
        os.replace(tmp, target)


def all_kernels():
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS[name] = lib
        return lib


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library for the host source csrc/<name>.cpp, built with
    g++ and HOST_FLAGS at first use, one per machine architecture; raises
    if it does not build."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            # host code: the checkout may be shared by hosts of several
            # architectures
            target = _target(name, "cpp", HOST_FLAGS + [platform.machine()])
            if not target.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = target.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run(
                    ["g++", *HOST_FLAGS, "-o", str(tmp),
                     str(CSRC / f"{name}.cpp")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed for csrc/{name}.cpp "
                                       f"(rc {proc.returncode}):\n"
                                       f"{proc.stdout}")
                os.replace(tmp, target)
            lib = ctypes.CDLL(str(target))
            _LIBS[name] = lib
        return lib
