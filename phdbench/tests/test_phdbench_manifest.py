"""BENCHMARK.json against the benchmark's contract: names, units, keys,
and every configuration, traffic mix and metric a file of its own."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["phdbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


@pytest.mark.parametrize("entry", METRICS + MAN["workloads"] + MAN["configs"],
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"]), entry["name"]
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_units_and_keys(metric):
    assert UNIT.match(metric["unit"]) and len(metric["unit"]) <= 16
    assert metric["better"] in ("lower", "higher")
    assert (ROOT / "phdbench" / "metrics" / f"{metric['name']}.py").is_file()
    if metric in MAN["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["moves"] in {m["name"] for m in MAN["end_to_end"]}
        assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200


def test_unique_names():
    for group in (METRICS, MAN["workloads"], MAN["configs"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cells_have_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    assert (ROOT / "phdbench" / "traffic" / f"{cell['traffic']}.json") \
        .is_file()
    cfg = next(c for c in MAN["configs"] if c["name"] == cell["config"])
    assert (ROOT / cfg["file"]).is_file()
    # every cell reports setup_s, another end-to-end metric and a per-layer
    for section, least in (("end_to_end", 2), ("per_layer", 1)):
        got = [m for m in MAN[section]
               if cell["name"] in m.get("workloads", [cell["name"]])]
        assert len(got) >= least


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    body = json.loads((ROOT / cfg["file"]).read_text())
    assert body["source"] == cfg["source"]
    assert (ROOT / body["data"] / "measurements.txt").is_file()
    assert set(body["limits"]) >= {"pose_m", "map_rel", "map_w2_rel_q999"}
