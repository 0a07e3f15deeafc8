"""The port's counterparts of the JAX package's TPU tools that hold
Pallas kernels: ``prop_ablate`` (the ZNCC kernel's cost decomposition)
and ``mosaic_probe`` (lane probes), each run as
``python -m acmmp_tpu_torch.tools.<name>``."""
