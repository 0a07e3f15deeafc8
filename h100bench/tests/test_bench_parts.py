"""The yardstick's parts on the CPU: the work tallies against hand
counts on true sizes, the scene's determinism, the metric readers, and
the import rules (nothing under h100bench/ imports JAX or the JAX
package; the reference imports nothing of the program).

    python -m pytest h100bench/tests"""

from __future__ import annotations

import ast
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from h100bench import harness, tally
from h100bench.scene import relief

PM = harness.load_json("h100bench/configs/dtu_1600.json")["patchmatch"]


def test_zncc_tally_hand_count():
    # 5 x 4 pixels (10 black, 10 red), 3 views, 36 taps, 2 iterations:
    # hypotheses scored = 20 at init + 2 * 13 * 10 + 2 * 13 * 10
    launches = tally.zncc_launches(4, 5, 3, PM)
    assert len(launches) == 1 + 3 * 4
    ops = sum(o for o, _ in launches)
    assert ops == 40 * 36 * 3 * (20 + 4 * 13 * 10)
    k1 = launches[0][1]
    assert k1 == 4 * 20 + 3 * 20 + 16 * 20 + 4 * 20 * 3
    k8 = launches[1][1]
    assert k8 == 4 * 10 + 3 * 20 + 16 * 8 * 10 + 4 * 8 * 10 * 3


def test_tally_counts_true_sizes_not_padding():
    # an odd grid: 3 x 5 = 15 pixels, 8 black (x + y even), 7 red
    assert tally.colours(3, 5) == (8, 7)
    launches = tally.geom_launches(3, 5, 2, PM)
    n = [15, 8, 8, 7, 7, 8, 8, 7, 7]
    ks = [1, 8, 5, 8, 5, 8, 5, 8, 5]
    assert [o for o, _ in launches] == [
        2 * (141 * k * m + 6 * m) for k, m in zip(ks, n)]
    assert launches[0][1] == 4 * 2 * 15 + 16 * 15 + 4 * 15 * 2


def test_bound_takes_the_larger_side():
    peaks = {"fp32_flops": 10.0, "hbm_bytes_per_s": 2.0}
    assert tally.bound_s([(100, 4), (10, 40)], peaks) == 10.0 + 20.0


def tiny_scene():
    sc = dict(harness.load_json("h100bench/configs/dtu_1600.json")["scene"])
    sc.update(image_width=48, image_height=32, views=5,
              sources_per_view=3, rig_rows=2, rig_cols=3,
              focal_px=2892.33 * 48 / 1600)
    return sc


def test_scene_deterministic_from_seed():
    sc = tiny_scene()
    a = relief.make_scene(sc, 2**31 + 77, "cpu")
    b = relief.make_scene(sc, 2**31 + 77, "cpu")
    c = relief.make_scene(sc, 5, "cpu")
    for x, y in ((a.images, b.images), (a.depth, b.depth),
                 (a.normal, b.normal)):
        assert torch.equal(x, y)
    assert not torch.equal(a.images, c.images)
    assert torch.equal(a.depth, c.depth)      # the seed draws texture only
    assert a.pairs == b.pairs and all(len(p) == 3 for p in a.pairs)
    assert all(i not in p for i, p in enumerate(a.pairs))
    assert float(a.images.min()) >= 0 and float(a.images.max()) <= 255
    assert torch.equal(a.images, torch.round(a.images))
    d0, n0 = relief.previous_pass(a, {"depth_noise": 0.01,
                                      "outlier_share": 0.05,
                                      "normal_noise": 0.1}, 9)
    d1, n1 = relief.previous_pass(b, {"depth_noise": 0.01,
                                      "outlier_share": 0.05,
                                      "normal_noise": 0.1}, 9)
    assert torch.equal(d0, d1) and torch.equal(n0, n1)


def test_scene_truth_is_the_surface():
    sc = tiny_scene()
    s = relief.make_scene(sc, 1, "cpu")
    assert float(s.depth.min()) > sc["depth_min"]
    assert float(s.depth.max()) < sc["depth_max"]
    # world normals face their cameras
    for i, v in enumerate(s.views):
        axis = torch.as_tensor(v.R[2])
        assert float((s.normal[i] * axis).sum(-1).max()) < 0


def test_texture_wavelength_is_a_patch():
    sc = tiny_scene()
    gen = torch.Generator().manual_seed(0)
    kx, ky, _, _ = relief._waves(sc, gen, "cpu")
    k = torch.sqrt(kx ** 2 + ky ** 2)
    wavelength_px = (2 * torch.pi / k) * sc["focal_px"] / sc["distance"]
    assert float(wavelength_px.min()) >= sc["texture_patch_px"] * 0.999
    assert float(wavelength_px.max()) <= (sc["texture_patch_px"]
                                          * sc["texture_octave_span"])


class _FakeTrace:
    def __init__(self):
        self.kernels = [("void zncc_kernel<8>", 0.0, 2.0),
                        ("geom_kernel", 2.5, 3.0),
                        ("elementwise", 3.0, 4.0)]
        self.units = 2
        self.window_s = 5.0
        self.busy_s = 4.0 - 0.5
        self.tally = {"zncc": [(67e12 * 0.5, 1)]}
        self.peaks = {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}

    kernel_time = harness.Trace.kernel_time
    kernel_count = harness.Trace.kernel_count


@pytest.mark.parametrize("metric,want", [
    ("zncc_roofline", 25.0),
    ("torch_ops_ms_per_map", 500.0),
    ("device_ops_per_map", 1.5),
    ("device_idle.solve", 30.0),
    ("geom_roofline", None),
])
def test_readers(metric, want):
    mspec = harness.load_json(f"h100bench/metrics/{metric}.json")
    reader = __import__(f"h100bench.metrics.{mspec['reader']}",
                        fromlist=["read"])
    got = reader.read(mspec, harness.Window(1.0), _FakeTrace())
    assert got == pytest.approx(want) if want is not None else got is None


def test_window_rate_and_setup():
    w = harness.Window(12.5)
    w.units, w.elapsed_s = 8, 2.0
    for name, want in (("maps_per_s", 4.0), ("setup_s", 12.5)):
        assert harness.read_metric({"name": name}, w, None) == want
    assert harness.read_metric({"name": "maps_per_s"}, harness.Window(1.0),
                               None) is None


def test_gaps_are_merged_and_labelled():
    tr = _FakeTrace()
    tr.busy_intervals = harness._union([(s, e) for _, s, e in tr.kernels])
    tr.host_ops = [("aten::item", 1.9, 2.6)]
    br = harness.Trace.breakdown(tr)
    assert br["device_ops"][0] == ["void zncc_kernel<8>", 2.0]
    assert br["idle_gaps"] == [["aten::item (1 gaps)", 0.5]]


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_and_a_clean_reference():
    for path in harness.HERE.rglob("*.py"):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in harness.FORBIDDEN, (path, mod)
            if "reference" in path.parts:
                assert top != "acmmp_tpu_torch", (path, mod)


def test_no_card_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "dtu_1600.geom_b4", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=harness.ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_benchmark_alone_exits_non_zero(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    (no program) gives no result."""
    shutil.copytree(harness.HERE, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload",
         "dtu_1600.geom_b4", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
