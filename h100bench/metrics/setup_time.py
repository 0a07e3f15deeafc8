"""Seconds from process start to the first timed unit: imports, the
CUDA context, the scene, staging, kernel builds and the warm-up."""


def read(spec, window, trace):
    return window.setup_s
