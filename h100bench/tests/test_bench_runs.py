"""Whole runs of the harness on the CPU at tiny sizes, the look for a
card stubbed and the kernels' plain versions in their place: the result
line's schema, each driver's rehearsal, the control coming out not
correct, and each fault planted under the timed path turning `correct`
false.

    python -m pytest h100bench/tests"""

from __future__ import annotations

import contextlib
import io
import json

import pytest
import torch

from h100bench import control, faults, harness

CELLS = ["dtu_1600.geom_b4", "eth3d_3200.geom_b1"]


def load_cell(name: str):
    """(workload, configuration, mix) of `<config>.<mix>` from their
    files, whether or not BENCHMARK.json lists the cell yet."""
    config, traffic = name.split(".", 1)
    return ({"name": name, "config": config, "traffic": traffic,
             "chips": 1},
            harness.load_json(f"h100bench/configs/{config}.json"),
            harness.load_json(f"h100bench/mixes/{traffic}.json"))


def shrink(cfg: dict, mix: dict) -> None:
    """A configuration and mix cut to a CPU test's size."""
    sc = cfg["scene"]
    sc.update(focal_px=sc["focal_px"] * 128 / sc["image_width"],
              image_width=128, image_height=96, views=6,
              sources_per_view=3, rig_rows=2, rig_cols=3)
    mix["view_batch"] = min(mix["view_batch"], 2)
    # the check draws the second or the first unit
    mix["check_among"] = 2


@pytest.fixture
def stubbed(monkeypatch):
    """run.main on the CPU: a card reported present, the driver on the
    CPU, every configuration shrunk."""
    from h100bench import run

    def tiny(sp, name):
        wl, cfg, mix = load_cell(name)
        shrink(cfg, mix)
        mix.update(go.mix)
        return wl, cfg, mix

    monkeypatch.setattr(harness, "cell", tiny)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3 (CPU stub)")
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(run, "DEVICE", "cpu")
    torch.set_num_threads(4)

    def go(workload, seed=5, seconds=6.0):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = run.main(["--workload", workload, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", "0"])
        assert rc == 0
        return json.loads(out.getvalue().strip().splitlines()[-1])
    go.mix = {}
    return go


@pytest.mark.parametrize("workload", CELLS)
def test_result_line(stubbed, workload):
    res = stubbed(workload)
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(res)
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    want = {m["name"] for m in harness.cell_metrics(
        harness.spec(), workload, "end_to_end")}
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


FAULTS = [("dtu_1600.geom_b4", f) for f in
          ("unchanged", "half_batch", "altered")] + [
    ("eth3d_3200.geom_b1", f) for f in ("unchanged", "altered")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_fails_the_check(stubbed, workload, fault):
    undo = faults.plant(fault)
    try:
        res = stubbed(workload, seed=6)
    finally:
        undo()
    assert res["correct"] is False, res["checks"]


def test_unit_never_reached_is_not_correct(stubbed):
    """A check unit drawn beyond what the window completed reads every
    number infinite."""
    stubbed.mix = {"check_among": 10 ** 9}
    res = stubbed("dtu_1600.geom_b4", seconds=1.0)
    assert res["correct"] is False
    assert all(c["value"] == float("inf") for c in res["checks"].values())


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    """The control, the reference in the precision below the stated one
    (the solve's ZNCC moments in bfloat16) in the program's place, fails
    the cell's limits."""
    torch.set_num_threads(4)
    _, cfg, mix = load_cell(workload)
    shrink(cfg, mix)
    numbers, ctl, _ = control.readings(cfg, mix, 8, 1, "cpu", control=True)
    limits = mix["limits"]
    assert all(numbers[k] <= v for k, v in limits.items())
    assert any(ctl[k] > v for k, v in limits.items()), ctl
