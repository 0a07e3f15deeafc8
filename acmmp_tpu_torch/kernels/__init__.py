"""Build-and-load of the port's hand-written CUDA kernels (see _build.py)."""
