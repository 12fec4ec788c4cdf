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


# a CPHD step's ranges: its own beside the PHD path's
CPHD_EVENTS = [
    ("bench.window", False, 100, 1100),
    ("bench.step", False, 100, 1000),
    ("cphd.pre", False, 120, 300),
    ("cphd.card", False, 300, 500),
    ("phd.merge", False, 500, 700),
    ("cphd.births", False, 700, 900),
    ("cphd.pre", True, 150, 350),
    ("cphd.card", True, 400, 600),
    ("phd.merge", True, 650, 800),
    ("cphd.births", True, 850, 950),
    ("k_pre", True, 140, 350),
    ("k_esf", True, 360, 395),        # in the gap before cphd.card
    ("k_card", True, 400, 600),
    ("k_merge", True, 650, 790),
    ("cardinality_predict_kernel", True, 850, 950),
]


def test_every_filters_ranges_are_layers():
    tl = from_events(CPHD_EVENTS)
    assert tl.layer_ns == {"cphd.pre": 210, "cphd.card": 35 + 200,
                           "phd.merge": 140, "cphd.births": 100}
    ctx = {"timeline": tl, "traced": {"steps": 2}}
    assert harness.load_reader("card.device_ms")(ctx) == pytest.approx(
        235e-6 / 2)
    # no phd.pre range: its reader finds nothing to read
    assert harness.load_reader("pre.device_ms")(ctx) is None
    # a gap is named by the filter's own host range
    gaps = dict((round(s * 1e9), n) for n, s in tl.breakdown()["idle_gaps"])
    assert gaps == {40: "bench.step", 10: "cphd.card", 5: "cphd.card",
                    50: "phd.merge", 60: "cphd.births", 150: "bench.step"}


def test_a_phd_timeline_reads_as_before():
    """The PHD step opens no cphd.* or disp.* range: its layers, gaps and
    breakdown are those of the phd.* rule alone."""
    tl = from_events(EVENTS)
    assert tl.layer_ns == {"phd.pre": 300, "phd.merge": 250,
                           "(after the ranges)": 50}
    b = tl.breakdown()
    assert [n for n, _ in b["device_ops"]] == ["k2", "k3", "k1",
                                                "ctypes_merge", "late"]
    assert [n for n, _ in b["idle_gaps"]] == ["phd.merge", "bench.readback",
                                              "bench.step", "bench.readback"]
    assert [s for _, s in b["idle_gaps"]] == pytest.approx(
        [150e-9, 150e-9, 100e-9, 50e-9])
