"""The reduction of a trace: busy time as the union of device intervals,
idle gaps named by the host range open when they began, and each device
operation given to the first layer range that ends after it starts."""

import pytest

from phdbench import harness
from phdbench.trace import from_events

EVENTS = [
    ("bench.window", False, 100, 1100),
    ("bench.step", False, 100, 600),
    ("phd.pre", False, 150, 400),
    ("phd.merge", False, 400, 600),
    ("bench.readback", False, 600, 1100),
    # device timeline: the layer ranges and the operations
    ("phd.pre", True, 200, 500),
    ("phd.merge", True, 700, 900),
    ("k1", True, 200, 300),
    ("k2", True, 250, 450),       # overlaps k1
    ("ctypes_merge", True, 600, 650),   # in the gap before phd.merge
    ("k3", True, 700, 900),
    ("late", True, 1050, 1200),   # clipped at the window's end
    ("early", True, 0, 50),       # before the window
]


def test_busy_idle_and_launches():
    tl = from_events(EVENTS)
    assert tl.window_s == pytest.approx(1e-6)
    assert tl.busy_ns() == (450 - 200) + 50 + 200 + 50
    ctx = {"timeline": tl, "traced": {"steps": 2}}
    idle = harness.load_reader("device.idle_pct")(ctx)
    assert idle == pytest.approx(100 * (1 - 550 / 1000))
    assert harness.load_reader("device.launches")(ctx) == 5 / 2


def test_layer_attribution_rule():
    tl = from_events(EVENTS)
    assert tl.layer_ns["phd.pre"] == 100 + 200
    assert tl.layer_ns["phd.merge"] == 50 + 200
    assert tl.layer_ns["(after the ranges)"] == 50
    ctx = {"timeline": tl, "traced": {"steps": 2}}
    assert harness.load_reader("pre.device_ms")(ctx) == pytest.approx(
        300e-6 / 2)
    assert harness.load_reader("merge.device_ms")(ctx) == pytest.approx(
        250e-6 / 2)


def test_breakdown_names_gaps_by_host_range():
    tl = from_events(EVENTS)
    b = tl.breakdown()
    assert [n for n, _ in b["device_ops"]][:2] == ["k2", "k3"]
    gaps = dict((round(s * 1e9), n) for n, s in b["idle_gaps"])
    assert gaps[150] == "bench.readback"     # 900-1050
    assert gaps[100] == "bench.step"         # 100-200, inside bench.step
    assert gaps[50] == "bench.readback"      # 650-700
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
