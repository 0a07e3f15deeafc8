"""The harness on the card: one short run of a cell, its result line
correct. Skips without a CUDA device (decided inside the test).

    python -m pytest -m cuda h100bench/tests/test_bench_card.py"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from h100bench import harness


@pytest.mark.cuda
def test_solve_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "dtu_1600.geom_b4", "--seed", "2147483713", "--seconds", "5",
         "--trace", "0"], capture_output=True, text=True, timeout=900,
        cwd=harness.ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["metrics"]["maps_per_s"]["value"] > 0
