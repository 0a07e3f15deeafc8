"""Host-side assembly of SolverInputs — the port of
``acmmp_tpu/engine/inputs.py``: u8 rounding, edge padding to static
shapes, view-axis padding and mask, relaxed depth range
(InputInitialization, src/ACMMP.cpp:525-636).

``solver_inputs_from_numpy`` carries a problem across from the JAX
package: its SolverInputs as numpy arrays plus a JAX key's words become
the port's inputs and key, so both packages solve the same problem with
the same random stream."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from acmmp_tpu_torch import runtime
from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.core.geometry import Camera, stack_cameras
from acmmp_tpu_torch.engine.patchmatch import SolverInputs
from acmmp_tpu_torch.io.dense_folder import NumpyCamera
from acmmp_tpu_torch.ops import keys


def round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def pad_image_edge(img: np.ndarray, ph: int, pw: int) -> np.ndarray:
    """Pad bottom/right to (ph, pw) with edge replication."""
    h, w = img.shape[:2]
    pad = [(0, ph - h), (0, pw - w)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad, mode="edge")


def build_solver_inputs(
    ref_img: np.ndarray,
    src_imgs: Sequence[np.ndarray],
    ref_cam: NumpyCamera,
    src_cams: Sequence[NumpyCamera],
    params: PatchMatchParams,
    *,
    num_views_pad: Optional[int] = None,
    pad_h: int = 8,
    pad_w: int = 128,
    device=None,
) -> SolverInputs:
    """Photometric-mode inputs on `device` (CUDA unless told otherwise)."""
    dev = runtime.resolve_device(device)
    V = len(src_imgs)
    Vp = num_views_pad or V
    if Vp < V:
        raise ValueError(f"num_views_pad={Vp} is below the {V} source views")

    H, W = ref_img.shape
    Hp, Wp = round_up(H, pad_h), round_up(W, pad_w)
    # sources may have different sizes; pad to a common static shape
    sh = max(max(s.shape[0] for s in src_imgs), 1)
    sw = max(max(s.shape[1] for s in src_imgs), 1)
    Hs, Ws = round_up(sh, pad_h), round_up(sw, pad_w)

    def _as_gray(img):
        img = np.asarray(img, np.float32)
        if params.ncc_src_u8:
            # 8-bit image contract (the reference samples uint8 textures)
            img = np.rint(np.clip(img, 0.0, 255.0))
        return img

    ref_p = pad_image_edge(_as_gray(ref_img), Hp, Wp)
    srcs = [pad_image_edge(_as_gray(s), Hs, Ws) for s in src_imgs]
    while len(srcs) < Vp:
        srcs.append(np.zeros((Hs, Ws), np.float32))
    cams: List[NumpyCamera] = list(src_cams)
    while len(cams) < Vp:
        cams.append(src_cams[0] if src_cams else ref_cam)
    view_mask = np.zeros((Vp,), bool)
    view_mask[:V] = True

    f32 = lambda a: torch.as_tensor(np.array(a, np.float32),  # noqa: E731
                                    device=dev)
    return SolverInputs(
        ref_img=f32(ref_p),
        src_imgs=f32(np.stack(srcs)),
        ref_cam=ref_cam.to_torch(dev),
        src_cams=stack_cameras([c.to_torch(dev) for c in cams]),
        view_mask=torch.as_tensor(view_mask, device=dev),
        depth_min=f32(np.float32(ref_cam.depth_min * params.depth_min_relax)),
        depth_max=f32(np.float32(ref_cam.depth_max * params.depth_max_relax)),
    )


def _camera(c, device) -> Camera:
    return Camera.from_numpy(c.K, c.R, c.t, c.width, c.height, c.depth_min,
                             c.depth_max, device=device)


def solver_inputs_from_numpy(arrays, key_data, device=None):
    """(port SolverInputs, port Key) from the JAX package's SolverInputs
    after ``jax.tree.map(np.asarray, inputs)`` and a key's
    ``jax.random.key_data`` words. Only the photometric fields are read."""
    dev = runtime.resolve_device(device)
    f32 = lambda a: torch.as_tensor(np.array(a, np.float32),  # noqa: E731
                                    device=dev)
    inputs = SolverInputs(
        ref_img=f32(arrays.ref_img),
        src_imgs=f32(arrays.src_imgs),
        ref_cam=_camera(arrays.ref_cam, dev),
        src_cams=_camera(arrays.src_cams, dev),
        view_mask=torch.as_tensor(np.array(arrays.view_mask, bool),
                                  device=dev),
        depth_min=f32(arrays.depth_min),
        depth_max=f32(arrays.depth_max),
    )
    return inputs, keys.from_key_data(key_data)
