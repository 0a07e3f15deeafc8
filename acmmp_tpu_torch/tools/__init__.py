"""The port's counterparts of the JAX package's tools: ``prop_ablate``
(the ZNCC kernel's cost decomposition) and ``mosaic_probe`` (lane
probes), which hold Pallas kernels there, and the quality tools
``fullscale_quality`` (DTU-protocol scores of one run_pipeline on the
relief scene) and ``rand_window_ab`` (the random-search laws compared),
each run as ``python -m acmmp_tpu_torch.tools.<name>``."""
