"""The plain reference's inputs: the host camera record and the
assembly of one solve's padded inputs (u8 rounding, edge padding to
static shapes, view-axis padding and mask, relaxed depth range). A
frozen copy of the program's ``NumpyCamera`` and ``build_solver_inputs``
(InputInitialization, ACMMP.cpp:525-636), so the reference stages its
problems itself from the scene the benchmark made."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from h100bench.reference.geometry import Camera, stack_cameras
from h100bench.reference.params import PatchMatchParams
from h100bench.reference.solver import SolverInputs


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
    dev = torch.device(device)
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
