"""acmmp_tpu_torch stands alone: it imports neither JAX nor the JAX
package, asks for CUDA by default, and never computes silently on the CPU
when the CUDA kernel is asked for. The CUDA-marked test runs only where a
card is present (chip_smoke.py does the full comparison there)."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from acmmp_tpu_torch import runtime
from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.engine.inputs import build_solver_inputs
from acmmp_tpu_torch.ops import cuda_ncc
from acmmp_tpu_torch.ops import ncc as tncc
from acmmp_tpu_torch.utils.synth import textured_plane_scene

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]

_CHILD = r"""
import importlib, pkgutil, sys
import acmmp_tpu_torch
names = [m.name for m in pkgutil.walk_packages(acmmp_tpu_torch.__path__,
                                               "acmmp_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "acmmp_tpu"
             or m.startswith("acmmp_tpu."))
print(len(names), bad)
assert not bad, bad
assert "acmmp_tpu_torch.ops.cuda_ncc" in sys.modules
assert "acmmp_tpu_torch.ops.cuda_geom" in sys.modules
assert "acmmp_tpu_torch.ops.cuda_sample" in sys.modules
for m in ("io.dmb", "io.ply", "io.priors", "utils.log", "engine.fusion",
          "pipeline.scheduler", "pipeline.batched", "parallel.sharding",
          "parallel.tiles", "parallel.multihost", "kernels._build", "cli",
          "tools.prop_ablate",
          "tools.mosaic_probe", "ops.cuda_ablate", "ops.cuda_probes",
          "io.colmap", "eval.dtu", "eval.obsmask", "eval.stats",
          "experiments.fixtures", "experiments.select_cams",
          "experiments.prior_sampler", "experiments.dtu_analysis",
          "experiments.visualize", "tools.fullscale_quality",
          "tools.rand_window_ab"):
    assert "acmmp_tpu_torch." + m in sys.modules, m
# the card machine may lack both: importing the package needs neither
assert "matplotlib" not in sys.modules and "cv2" not in sys.modules
"""


def test_package_imports_neither_jax_nor_acmmp_tpu():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_RESIZE_CHILD = r"""
import sys
import numpy as np
from acmmp_tpu_torch.io import dense_folder
from acmmp_tpu_torch.kernels import _build
out = dense_folder.resize_image(np.arange(48, dtype=np.float32).reshape(6, 8),
                                4, 3)
assert out.shape == (3, 4) and out.dtype == np.float32, out
lib = _build._LIBS["host_resize"]
assert lib._name.startswith(str(_build.BUILD_DIR)), lib._name
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "acmmp_tpu"
             or m.startswith("acmmp_tpu."))
assert not bad, bad
"""


def test_host_resize_library_is_the_ports_own():
    """The resize's host library is built from the port's own source into
    build/torch_kernels/ and loads without JAX or the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _RESIZE_CHILD], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_neither_jax_nor_acmmp_tpu():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    froms = [n for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module]
    mods += [n.module for n in froms]
    mods += [f"{n.module}.{a.name}" for n in froms for a in n.names]
    assert "acmmp_tpu_torch.engine.patchmatch" in mods
    # it drives every kernel of the path
    assert "acmmp_tpu_torch.ops.cuda_ncc" in mods
    assert "acmmp_tpu_torch.ops.cuda_geom" in mods
    assert "acmmp_tpu_torch.ops.cuda_sample" in mods
    assert "acmmp_tpu_torch.ops.cuda_ablate" in mods
    assert "acmmp_tpu_torch.ops.cuda_probes" in mods
    # and the tools through their entry points
    assert "acmmp_tpu_torch.tools.prop_ablate" in mods
    assert "acmmp_tpu_torch.tools.mosaic_probe" in mods
    # and the pipeline through its entry point, on the device mesh too
    assert "acmmp_tpu_torch.pipeline.scheduler" in mods
    assert "acmmp_tpu_torch.parallel.sharding" in mods
    assert "acmmp_tpu_torch.parallel.tiles" in mods
    # and across processes, through the CLI (phase 12)
    assert "acmmp_tpu_torch.parallel.multihost" in mods
    assert not [m for m in mods if m.split(".")[0] in ("jax", "acmmp_tpu")]


def _small_inputs():
    images, cams, _ = textured_plane_scene(n_views=3, width=32, height=16)
    return build_solver_inputs(images[0], images[1:], cams[0], cams[1:],
                               PatchMatchParams(patch_size=3),
                               device="cpu")


def test_cuda_backend_on_cpu_tensors_raises():
    inp = _small_inputs()
    vg = tncc.make_view_geometry(inp.ref_cam, inp.src_cams)
    planes = torch.zeros(inp.ref_img.shape + (4,))
    planes[..., 2] = -1.0
    planes[..., 3] = 5.0
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        tncc.multiview_zncc(inp.ref_img, inp.src_imgs, vg, planes,
                            PatchMatchParams(ncc_backend="cuda"))
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        cuda_ncc.multiview_zncc_cuda(inp.ref_img, inp.src_imgs, vg,
                                     planes[None], PatchMatchParams())
    with pytest.raises(ValueError, match="ncc_backend"):
        tncc.multiview_zncc(inp.ref_img, inp.src_imgs, vg, planes,
                            PatchMatchParams(ncc_backend="pallas"))
    # "auto" on CPU tensors is the plain version, and counts no launch
    before = cuda_ncc.total_launches()
    out = tncc.multiview_zncc(inp.ref_img, inp.src_imgs, vg, planes,
                              PatchMatchParams(patch_size=3))
    assert out.shape == inp.ref_img.shape + (2,)
    assert cuda_ncc.total_launches() == before


def test_entry_points_default_to_cuda(monkeypatch):
    from acmmp_tpu_torch.parallel import make_view_mesh
    from acmmp_tpu_torch.parallel.tiles import make_tile_mesh

    assert runtime.DEFAULT_DEVICE == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        runtime.resolve_device()
    # a mesh of the visible devices: no quiet list of CPUs
    for make in (make_view_mesh, make_tile_mesh):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert runtime.resolve_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    images, cams, _ = textured_plane_scene(n_views=4, width=128, height=32)
    inp = build_solver_inputs(images[0], images[1:], cams[0], cams[1:],
                              PatchMatchParams(), device="cuda")
    vg = tncc.make_view_geometry(inp.ref_cam, inp.src_cams)
    rng = np.random.default_rng(0)
    d = torch.as_tensor(rng.uniform(4, 6, size=(3,) + inp.ref_img.shape),
                        dtype=torch.float32, device="cuda")
    planes = torch.zeros(d.shape + (4,), device="cuda")
    planes[..., 2] = -1.0
    planes[..., 3] = d
    got = tncc.multiview_zncc(inp.ref_img, inp.src_imgs, vg, planes,
                              PatchMatchParams(), n_views=3)
    want = tncc.multiview_zncc(inp.ref_img, inp.src_imgs, vg, planes,
                               PatchMatchParams(ncc_backend="plain"))
    bad = (got - want).abs() > 2e-3 + 1e-3 * want.abs()
    assert bad.float().mean().item() < 1e-3
