"""Entry point of the port — the twin of ``__graft_entry__.entry``.

``entry()`` returns ``(fn, (inputs, key))``: one full photometric
PatchMatch solve for one reference view of a synthetic 4-camera scene,
on CUDA unless the caller passes ``device="cpu"``."""

from __future__ import annotations

from acmmp_tpu_torch.config import PatchMatchParams
from acmmp_tpu_torch.engine.inputs import build_solver_inputs
from acmmp_tpu_torch.engine.patchmatch import Mode, run_patchmatch
from acmmp_tpu_torch.ops import keys
from acmmp_tpu_torch.utils.synth import textured_plane_scene


def example_problem(n_views=4, width=128, height=64, device=None):
    params = PatchMatchParams()
    images, cams, _ = textured_plane_scene(n_views=n_views, width=width,
                                           height=height)
    inputs = build_solver_inputs(images[0], images[1:], cams[0], cams[1:],
                                 params, device=device)
    return inputs, keys.key(0), params


def entry(device=None):
    """(fn, example_args): fn(inputs, key) runs one full solve."""
    inputs, key, params = example_problem(device=device)
    mode = Mode()

    def fn(inputs, key):
        return run_patchmatch(inputs, key, params, mode)

    return fn, (inputs, key)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry: ok", tuple(out.depth.shape), out.depth.device)
