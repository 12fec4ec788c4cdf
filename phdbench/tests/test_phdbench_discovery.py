"""A configuration, traffic mix or metric added as a file is found by its
name, with no edit to the harness."""

import json
import shutil
from pathlib import Path

from phdbench import harness

ROOT = Path(__file__).resolve().parents[2]


def _tree(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / "phdbench" / sub, tmp_path / "phdbench" / sub)
    return tmp_path


def test_new_files_are_found_by_name(tmp_path):
    root = _tree(tmp_path)
    man = json.loads((root / "BENCHMARK.json").read_text())
    body = json.loads((root / "phdbench/configs/dense-phd.json").read_text())
    body["config"]["n_particles"] = 2048
    (root / "phdbench/configs/dense-small.json").write_text(json.dumps(body))
    (root / "phdbench/traffic/burst.json").write_text(
        json.dumps({"loop": "step"}))
    (root / "phdbench/metrics/device.busy_ms.py").write_text(
        "def read(ctx):\n    return 2.5 * ctx['x']\n")
    man["configs"].append({"name": "dense-small", "source": "s",
                           "file": "phdbench/configs/dense-small.json",
                           "reduced": [], "why": "w"})
    man["workloads"].append({"name": "dense-small.burst",
                             "config": "dense-small", "traffic": "burst",
                             "chips": 1, "why": "w"})
    man["per_layer"].append({"name": "device.busy_ms", "unit": "ms",
                             "better": "lower", "source": "device_trace",
                             "layer": "device", "moves": "steps_per_s",
                             "workloads": ["dense-small.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    cell = harness.load_cell("dense-small.burst", root)
    assert cell["config_file"]["config"]["n_particles"] == 2048
    assert cell["traffic_file"]["loop"] == "step"
    names = harness.cell_metrics("dense-small.burst", "per_layer", root)
    assert names == ["device.busy_ms"]
    assert harness.load_reader("device.busy_ms", root)({"x": 2.0}) == 5.0
    # the cells already there are unchanged by the additions
    assert "device.busy_ms" not in harness.cell_metrics(
        "dense-phd.replay", "per_layer", root)


def test_every_declared_metric_has_a_reader():
    man = harness.manifest()
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
