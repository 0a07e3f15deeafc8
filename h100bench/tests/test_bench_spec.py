"""BENCHMARK.json and the files it names: every configuration, mix,
metric and cell loads, the spec keeps the contract's form, and a new
configuration, mix and metric are new files and entries only.

    python -m pytest h100bench/tests"""

from __future__ import annotations

import importlib
import json
import re
import shutil
import sys

import pytest

from h100bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def sp():
    return harness.spec()


def test_top_level_keys(sp):
    assert set(sp) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert sp["command"] == ["python3", "h100bench/run.py"]
    assert sp["paths"] == ["h100bench"]
    assert 1 <= sp["run_seconds"] <= 51
    assert isinstance(sp["run_seconds"], int)
    assert len(json.dumps(sp)) <= 64 * 1024


def test_names_units_and_lines(sp):
    names = ([c["name"] for c in sp["configs"]]
             + [w["name"] for w in sp["workloads"]]
             + [m["name"] for m in sp["end_to_end"] + sp["per_layer"]])
    for n in names + [w["traffic"] for w in sp["workloads"]]:
        assert NAME.match(n), n
    assert len(names) == len(set(names))
    for m in sp["end_to_end"] + sp["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for text in ([w["why"] for w in sp["workloads"]]
                 + [c["why"] for c in sp["configs"]]
                 + [c["source"] for c in sp["configs"]]
                 + [m["layer"] for m in sp["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text
        assert "\t" not in text


def test_configs(sp):
    files = set()
    for c in sp["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("h100bench/")
        assert c["file"] not in files
        files.add(c["file"])
        cfg = harness.load_json(c["file"])
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
            assert not k.endswith(("_dim", "_rank"))
        assert any(w["config"] == c["name"] for w in sp["workloads"])


def test_cells_and_metrics(sp):
    e2e = {m["name"]: m for m in sp["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in sp["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    pairs = set()
    four = 0
    for w in sp["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        wl, cfg, mix = harness.cell(sp, w["name"])
        importlib.import_module(f"h100bench.drivers.{mix['driver']}")
        got = harness.cell_metrics(sp, w["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in got} and len(got) >= 2
        assert harness.cell_metrics(sp, w["name"], "per_layer")
        assert mix["limits"]
    assert four <= max(1, len(sp["workloads"]) // 4)
    for m in sp["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", ()):
            moved = e2e[m["moves"]]
            assert w in moved.get("workloads", [w])
    for m in sp["end_to_end"] + sp["per_layer"]:
        mspec = harness.load_json(f"h100bench/metrics/{m['name']}.json")
        reader = importlib.import_module(
            f"h100bench.metrics.{mspec['reader']}")
        assert callable(reader.read)


def test_layers_named_alike(sp):
    layers = {m["layer"] for m in sp["per_layer"]}
    for m in sp["per_layer"]:
        assert m["layer"].strip() == m["layer"]
    assert layers


def test_new_cell_is_files_and_entries(tmp_path, monkeypatch):
    """A dummy configuration, mix and per-layer metric, added as new
    files and BENCHMARK.json entries in a copy of the checkout, are
    found by name and read, with no harness file edited."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    sp = harness.spec()
    cfg = harness.load_json("h100bench/configs/dtu_1600.json")
    cfg["name"] = "dummy_cfg"
    (root / "h100bench/configs/dummy_cfg.json").write_text(json.dumps(cfg))
    mix = harness.load_json("h100bench/mixes/geom_b4.json")
    mix["view_batch"] = 2
    (root / "h100bench/mixes/dummy_mix.json").write_text(json.dumps(mix))
    (root / "h100bench/metrics/dummy_metric.json").write_text(json.dumps(
        {"reader": "dummy_reader"}))
    (root / "h100bench/metrics/dummy_reader.py").write_text(
        "def read(spec, window, trace):\n    return 2.0 * window.units\n")
    sp["configs"].append({"name": "dummy_cfg", "source": "a test",
                          "file": "h100bench/configs/dummy_cfg.json",
                          "reduced": [], "why": "a test"})
    sp["workloads"].append({"name": "dummy_cfg.dummy_mix",
                            "config": "dummy_cfg", "traffic": "dummy_mix",
                            "chips": 1, "why": "a test"})
    sp["end_to_end"][0]["workloads"].append("dummy_cfg.dummy_mix")
    sp["per_layer"].append({"name": "dummy_metric", "unit": "x",
                            "better": "higher", "source": "program_counter",
                            "layer": "a test", "moves": sp["end_to_end"][0]
                            ["name"], "workloads": ["dummy_cfg.dummy_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(sp))
    for name in [m for m in sys.modules if m.startswith("h100bench")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.syspath_prepend(str(root))
    h = importlib.import_module("h100bench.harness")
    assert h.ROOT == root
    sp2 = h.spec()
    wl, cfg2, mix2 = h.cell(sp2, "dummy_cfg.dummy_mix")
    assert cfg2["name"] == "dummy_cfg" and mix2["view_batch"] == 2
    pl = h.cell_metrics(sp2, "dummy_cfg.dummy_mix", "per_layer")
    assert [m["name"] for m in pl] == ["dummy_metric"]
    w = h.Window(1.0)
    w.units = 3
    assert h.read_metric(pl[0], w, None) == 6.0
