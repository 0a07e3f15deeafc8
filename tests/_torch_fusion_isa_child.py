"""Child of tests/test_torch_fusion.py: the JAX package's fuse_views of
the views in an .npz file, plain and prior-aware, compiled by XLA:CPU for
a host capped at the ISA the parent puts in XLA_FLAGS. Writes each
variant's points, normals and colours to another .npz.

    XLA_FLAGS=--xla_cpu_max_isa=AVX2 \
        python tests/_torch_fusion_isa_child.py IN OUT
"""

import sys

import jax

jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: E402

from acmmp_tpu.config import FusionParams  # noqa: E402
from acmmp_tpu.engine import fusion  # noqa: E402
from acmmp_tpu.io.dense_folder import NumpyCamera, Problem  # noqa: E402


def main(src, dst):
    a = dict(np.load(src))
    n = len(a["depth"])
    out = {}
    for prior_aware in (False, True):
        views = {}
        for i in range(n):
            cam = NumpyCamera(K=a["K"][i], R=a["R"][i], t=a["t"][i],
                              depth_min=float(a["depth_min"][i]),
                              depth_max=float(a["depth_max"][i]),
                              width=int(a["width"][i]),
                              height=int(a["height"][i]))
            kw = (dict(depth1=a["depth1"][i], normal1=a["normal1"][i])
                  if prior_aware else {})
            views[i] = fusion.FusionView(a["image"][i], cam, a["depth"][i],
                                         a["normal"][i], **kw)
        problems = [Problem(ref_image_id=i,
                            src_image_ids=[j for j in range(n) if j != i])
                    for i in range(n)]
        res = fusion.fuse_views(
            views, problems, FusionParams(num_consistent_thresh=2),
            prior_aware=prior_aware,
            single_match_penalty=1 if prior_aware else 0)
        tag = "dual" if prior_aware else "plain"
        for name, v in zip(("pts", "nrm", "col"), res):
            out[f"{tag}_{name}"] = np.asarray(v)
    np.savez(dst, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
