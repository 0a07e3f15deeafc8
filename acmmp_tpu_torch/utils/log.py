"""Structured logging and per-stage metrics — the port of
``acmmp_tpu/utils/log.py``.

Every stage reports structured metrics (valid-depth fraction, cost
quantiles) and its wall time, and the profiler is toggled with one
environment variable: ``ACMMP_TPU_PROFILE=<dir>`` wraps each stage in a
``torch.profiler`` trace written to ``<dir>/<stage>.json``."""

from __future__ import annotations

import logging
import os
import time
from contextlib import contextmanager

import numpy as np

_ROOT = "acmmp_tpu_torch"


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(f"{_ROOT}.{name}")
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        root.addHandler(handler)
        root.setLevel(os.environ.get("ACMMP_TPU_LOGLEVEL", "INFO"))
    return logger


def stage_metrics(log: logging.Logger, tag: str, depth: np.ndarray,
                  cost: np.ndarray) -> None:
    valid = float((depth > 0).mean())
    log.info(
        "%s: valid_depth=%.3f cost_p50=%.4f cost_p90=%.4f",
        tag, valid, float(np.median(cost)), float(np.percentile(cost, 90)),
    )


@contextmanager
def profiled(tag: str):
    """Log the stage's wall time (the record carries `stage` and
    `seconds`); with ACMMP_TPU_PROFILE set to a directory, also trace the
    stage with torch.profiler (CPU and, where present, CUDA activity)."""
    log = get_logger("stage")
    prof_dir = os.environ.get("ACMMP_TPU_PROFILE")
    t0 = time.perf_counter()
    if not prof_dir:
        yield
        dt = time.perf_counter() - t0
    else:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            yield
        dt = time.perf_counter() - t0
        os.makedirs(prof_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(prof_dir, f"{tag}.json"))
    log.info("%s took %.3f s", tag, dt, extra={"stage": tag, "seconds": dt})
