"""The trace read by launch (``launches.py``) and the readings of the
program's spans (``spans.py``) on synthetic events: each device operation
to the innermost program span open when its launch call was made (a
ctypes launch with no call of its own through its ``kernel.*`` span),
each idle gap named by its span and the host's state, and the accepted
reduction (``trace.py``) reading the same with the program's host-only
spans in the trace."""

import pytest

from phdbench import harness
from phdbench.launches import Event, blocked, read
from phdbench.spans import readings
from phdbench.trace import from_events

from test_phdbench_trace import EVENTS

RT = "cuda_runtime"
OP, USER, KERNEL = "cpu_op", "user_annotation", "kernel"

SYNTH = [
    Event("bench.traced", USER, False, 0, 1000),
    Event("runner.step", OP, False, 100, 600, corr=7),
    Event("phd.pre", USER, False, 150, 400, corr=8),
    Event("cudaLaunchKernel", RT, False, 160, 170, corr=1),
    Event("kernel.detect", OP, False, 200, 260, corr=9),  # ctypes: no call
    Event("aten::sort", OP, False, 340, 370, corr=13),
    Event("phd.merge", USER, False, 400, 600, corr=10),
    Event("cudaLaunchKernel", RT, False, 410, 415, corr=2),
    Event("kernel.merge2d", OP, False, 440, 450, corr=500),
    Event("host.gc", OP, False, 470, 560, corr=11),
    Event("bench.readback", USER, False, 600, 1000, corr=12),
    Event("cudaMemcpyAsync", RT, False, 605, 615, corr=4),
    Event("cudaStreamSynchronize", RT, False, 620, 900, corr=5),
    # the device: the layer ranges drawn there, then the operations
    Event("phd.pre", "gpu_user_annotation", True, 300, 420),
    Event("k1", KERNEL, True, 300, 350, corr=1),
    Event("detect_kernel", KERNEL, True, 360, 420, corr=99),
    Event("k2", KERNEL, True, 430, 480, corr=2),
    Event("merge2d_kernel", KERNEL, True, 480, 500, corr=98, linked=500),
    Event("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", True, 616, 640,
          corr=4),
    Event("mystery", KERNEL, True, 950, 980, corr=77),
]


def test_device_time_by_launching_span():
    la = read(SYNTH, "bench.traced")
    assert la.n_ops == 6 and la.total_ns == 50 + 60 + 50 + 20 + 24 + 30
    assert la.innermost_ns == {"phd.pre": 50, "kernel.detect": 60,
                               "phd.merge": 50, "kernel.merge2d": 20}
    assert la.inside_ns == {"runner.step": 180, "phd.pre": 110,
                            "kernel.detect": 60, "phd.merge": 70,
                            "kernel.merge2d": 20}
    assert la.outside_ns == 24                  # the harness's copy
    assert (la.n_unmatched, la.unmatched_ns) == (1, 30)
    assert la.matched_by == {"call": 3, "linked span": 1,
                             "kernel span in order": 1}
    assert la.calls == {
        "phd.pre": {"cudaLaunchKernel": [1, 10]},
        "phd.merge": {"cudaLaunchKernel": [1, 5]},
        "bench.readback": {"cudaMemcpyAsync": [1, 10],
                           "cudaStreamSynchronize": [1, 280]}}
    assert sum(la.innermost_ns.values()) + la.outside_ns \
        + la.unmatched_ns == la.total_ns


def test_gaps_named_by_span_and_host_state():
    la = read(SYNTH, "bench.traced")
    gaps = {(lo, hi): rest for lo, hi, *rest in la.gaps}
    assert gaps == {
        (0, 300): ["(outside the program's spans)", "issuing", ""],
        (350, 360): ["phd.pre", "issuing", "aten::sort"],
        (420, 430): ["phd.merge", "issuing", ""],
        (500, 616): ["phd.merge", "host.gc", ""],
        (640, 950): ["bench.readback", "cudaStreamSynchronize", ""],
        (980, 1000): ["bench.readback", "issuing", ""]}
    assert la.gap_ns(blocked_only=True) == 116 + 310
    assert la.longest_gaps(2) == [
        ["bench.readback", "cudaStreamSynchronize", 310e-6, ""],
        ["(outside the program's spans)", "issuing", 300e-6, ""]]


@pytest.mark.parametrize("host, want", [
    ("issuing", False), ("cudaLaunchKernel", False), ("host.gc", True),
    ("cudaStreamSynchronize", True), ("cudaDeviceSynchronize", True),
    ("cudaEventSynchronize", True), ("cudaMalloc", True), ("cudaFree", True),
    ("cudaMemcpyAsync", False), ("cudaMemcpyAsync (pageable)", True),
    ("cuLaunchKernel", False), ("cudaHostAlloc", True)])
def test_blocking_calls(host, want):
    assert blocked(host) is want


def test_readings_of_a_snapshot():
    snap = {"spans": {"runner.step": {"count": 4, "incl_ms": 30.0},
                      "runner.noise": {"count": 4, "incl_ms": 2.0},
                      "phd.pre": {"count": 4, "incl_ms": 12.0}},
            "work": {"map.live_components": {"sum": 300, "count": 8},
                     "merge.entering_lanes": {"sum": 40, "count": 8}}}
    la = read(SYNTH, "bench.traced")
    got = readings(snap, la, traced_steps=2)
    assert got == pytest.approx({
        "runner.issue_ms": 8.0, "pre.host_ms": 3.0,
        "map.live_components": 37.5, "merge.entering_lanes": 5.0,
        "pre.launched_device_ms": 110e-6 / 2,
        "merge.launched_device_ms": 70e-6 / 2,
        "device.idle_blocked_pct": 100 * 426 / 1000})
    # nothing recorded: nothing read (a program without the spans)
    assert readings({"spans": {}, "work": {}}, None, 0) == {}


# the program's host-only spans: CPU events, no device range
PROGRAM_HOST_SPANS = [
    ("runner.noise", False, 90, 100), ("runner.step", False, 100, 600),
    ("kernel.detect", False, 200, 260), ("kernel.merge2d", False, 420, 450),
    ("sync.has_z", False, 110, 115), ("host.gc", False, 470, 560),
]


def test_accepted_reduction_reads_the_same_with_host_spans():
    old, new = from_events(EVENTS), from_events(EVENTS + PROGRAM_HOST_SPANS)
    assert (new.window_ns, new.ops, new.layer_ns, new.host_ranges) == (
        old.window_ns, old.ops, old.layer_ns, old.host_ranges)
    assert new.breakdown() == old.breakdown()
    for name in ("pre.device_ms", "merge.device_ms", "device.idle_pct",
                 "device.launches"):
        reader = harness.load_reader(name)
        assert reader({"timeline": new, "traced": {"steps": 2}}) == \
            reader({"timeline": old, "traced": {"steps": 2}}), name
