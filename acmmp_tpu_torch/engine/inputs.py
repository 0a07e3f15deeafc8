"""Host-side assembly of SolverInputs — the port of
``acmmp_tpu/engine/inputs.py``: u8 rounding, edge padding to static
shapes, view-axis padding and mask, relaxed depth range
(InputInitialization, src/ACMMP.cpp:525-636).

``solver_inputs_from_numpy`` carries a problem across from the JAX
package: its SolverInputs as numpy arrays plus a JAX key's words become
the port's inputs and key, so both packages solve the same problem with
the same random stream; ``solver_inputs_batch_from_numpy`` does so for a
batch of views (the inputs and keys of the JAX package's batched
executor)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from acmmp_tpu_torch import runtime
from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.core.geometry import Camera, stack_cameras
from acmmp_tpu_torch.engine.patchmatch import SolverInputs
from acmmp_tpu_torch.io.dense_folder import NumpyCamera
from acmmp_tpu_torch.ops import keys
from acmmp_tpu_torch.parallel.sharding import stack_solver_inputs


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
    src_depths: Optional[Sequence[np.ndarray]] = None,
    init_depth: Optional[np.ndarray] = None,
    init_normal_world: Optional[np.ndarray] = None,
    init_cost: Optional[np.ndarray] = None,
    prior_planes: Optional[np.ndarray] = None,
    prior_mask: Optional[np.ndarray] = None,
    seed_planes: Optional[np.ndarray] = None,
    pre_costs: Optional[np.ndarray] = None,
    device=None,
) -> SolverInputs:
    """Inputs of one solve on `device` (CUDA unless told otherwise). The
    optional maps are those of the JAX package's `build_solver_inputs`:
    `src_depths` are edge-padded to the sources' shape, with zero maps for
    padded view slots; the [H, W] fields are zero-padded, and `prior_mask`
    is a bool."""
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

    depths = None
    if src_depths is not None:
        dl = [pad_image_edge(np.asarray(d, np.float32), Hs, Ws)
              for d in src_depths]
        while len(dl) < Vp:
            dl.append(np.zeros((Hs, Ws), np.float32))
        depths = f32(np.stack(dl))

    def _pad_hw(a):
        if a is None:
            return None
        a = np.asarray(a, np.float32)
        pad = ([(0, Hp - a.shape[0]), (0, Wp - a.shape[1])]
               + [(0, 0)] * (a.ndim - 2))
        return f32(np.pad(a, pad, mode="constant"))

    pm = None
    if prior_mask is not None:
        m = np.zeros((Hp, Wp), bool)
        m[:H, :W] = np.asarray(prior_mask, bool)
        pm = torch.as_tensor(m, device=dev)

    return SolverInputs(
        ref_img=f32(ref_p),
        src_imgs=f32(np.stack(srcs)),
        ref_cam=ref_cam.to_torch(dev),
        src_cams=stack_cameras([c.to_torch(dev) for c in cams]),
        view_mask=torch.as_tensor(view_mask, device=dev),
        depth_min=f32(np.float32(ref_cam.depth_min * params.depth_min_relax)),
        depth_max=f32(np.float32(ref_cam.depth_max * params.depth_max_relax)),
        src_depths=depths,
        init_depth=_pad_hw(init_depth),
        init_normal_world=_pad_hw(init_normal_world),
        init_cost=_pad_hw(init_cost),
        prior_planes=_pad_hw(prior_planes),
        prior_mask=pm,
        seed_planes=_pad_hw(seed_planes),
        pre_costs=_pad_hw(pre_costs),
    )


def _camera(c, device) -> Camera:
    return Camera.from_numpy(c.K, c.R, c.t, c.width, c.height, c.depth_min,
                             c.depth_max, device=device)


def solver_inputs_from_numpy(arrays, key_data, device=None):
    """(port SolverInputs, port Key) from the JAX package's SolverInputs
    after ``jax.tree.map(np.asarray, inputs)`` and a key's
    ``jax.random.key_data`` words. Every optional field is carried."""
    dev = runtime.resolve_device(device)
    f32 = lambda a: torch.as_tensor(np.array(a, np.float32),  # noqa: E731
                                    device=dev)
    opt = lambda a: None if a is None else f32(a)               # noqa: E731
    inputs = SolverInputs(
        ref_img=f32(arrays.ref_img),
        src_imgs=f32(arrays.src_imgs),
        ref_cam=_camera(arrays.ref_cam, dev),
        src_cams=_camera(arrays.src_cams, dev),
        view_mask=torch.as_tensor(np.array(arrays.view_mask, bool),
                                  device=dev),
        depth_min=f32(arrays.depth_min),
        depth_max=f32(arrays.depth_max),
        src_depths=opt(arrays.src_depths),
        init_depth=opt(arrays.init_depth),
        init_normal_world=opt(arrays.init_normal_world),
        init_cost=opt(arrays.init_cost),
        prior_planes=opt(arrays.prior_planes),
        prior_mask=(None if arrays.prior_mask is None else torch.as_tensor(
            np.array(arrays.prior_mask, bool), device=dev)),
        seed_planes=opt(arrays.seed_planes),
        pre_costs=opt(arrays.pre_costs),
    )
    return inputs, keys.from_key_data(key_data)


def solver_inputs_batch_from_numpy(
        arrays_list: Sequence, key_data_list: Sequence,
        device=None) -> Tuple[SolverInputs, keys.KeyBatch]:
    """(batched port SolverInputs, port KeyBatch) of B views: each view's
    JAX SolverInputs as numpy arrays and its key's words, carried across
    by `solver_inputs_from_numpy` and stacked on a leading [B]
    (parallel/sharding.stack_solver_inputs)."""
    pairs = [solver_inputs_from_numpy(a, k, device=device)
             for a, k in zip(arrays_list, key_data_list, strict=True)]
    return (stack_solver_inputs([p[0] for p in pairs]),
            keys.stack([p[1] for p in pairs]))
