"""The roofline counts on known shapes, and a share read from a trace."""

import math

import pytest

from phdbench import harness, roofline
from phdbench.trace import from_events


def test_detect_bound_dense_is_operation_bound():
    # 21 operations a lane over P=1024, M=72, K=1024
    t = roofline.detect_bound_s(1024, 72, 1024, 32)
    assert t == pytest.approx(21 * 1024 * 72 * 1024 / 67e12)
    assert t == pytest.approx(2.3663e-5, rel=1e-4)


def test_detect_bound_ackerman_is_byte_bound():
    P, M, K, T = 512, 48, 128, 16
    n_bytes = 4 * (6 * P * K + 4 * M) + 8 * P * M * T + 8 * P * M
    assert roofline.detect_bound_s(P, M, K, T) == pytest.approx(
        n_bytes / 3.35e12)
    assert roofline.detect_bound_s(P, M, K, T) == pytest.approx(1.46745e-6,
                                                                rel=1e-4)


def test_merge_bound_counts_activity_and_output_planes():
    assert roofline.merge_bound_s(10240, 1536, 1024) == pytest.approx(
        4 * (10240 * 1536 + 8 * 10240 * 1024) / 3.35e12)


def _window(ops):
    ev = [("bench.window", False, 0, 10_000_000)]
    ev += [("phd.pre", False, 0, 5_000_000), ("phd.pre", True, 0, 5_000_000)]
    return from_events(ev + [(n, True, lo, hi) for n, lo, hi in ops])


def test_roofline_share_from_a_trace():
    s = dict(P=10240, M=72, K=1024, T=32, cap=1536)
    ops = [("void detect_kernel<32>(float const*)", 0, 2_000_000),
           ("void detect_kernel<32>(float const*)", 3_000_000, 5_000_000),
           ("elementwise_kernel", 5_000_000, 6_000_000)]
    # two steps of 40 and 65 valid measurements, scans padded to 72: the
    # bound counts the valid ones
    ctx = {"timeline": _window(ops), "shapes": s,
           "traced": {"steps": 2, "z_counts": [40, 65]}}
    got = harness.load_reader("detect.roofline_pct")(ctx)
    want = 100 * (roofline.detect_bound_s(10240, 40, 1024, 32)
                  + roofline.detect_bound_s(10240, 65, 1024, 32)) / 4e-3
    assert got == pytest.approx(want)
    assert got < 100 * 2 * roofline.detect_bound_s(10240, 72, 1024, 32) \
        / 4e-3
    assert 0 < got <= 100
    # nothing matches: the reader returns nothing, never 0
    assert harness.load_reader("merge.roofline_pct")(ctx) is None


def test_merge_share_matches_its_kernels():
    s = dict(P=10240, M=72, K=1024, T=32, cap=1536)
    ops = [("void merge2d_kernel<256, false, 0>(float const*)", 0, 1_000_000),
           ("void wide_kernel<Gauss2, 256, 8, false>(x)", 2_000_000,
            3_000_000)]
    # one step that updates the map, its merge in two launches: the work
    # is the step's, counted once
    ctx = {"timeline": _window(ops), "shapes": s,
           "traced": {"steps": 1, "z_counts": [60]}}
    got = harness.load_reader("merge.roofline_pct")(ctx)
    assert got == pytest.approx(100 * roofline.merge_bound_s(
        10240, 1536, 1024) / 2e-3)
    assert math.isfinite(got)


def test_cardinality_bound_is_byte_bound():
    """PERF.md's row c: ~0.0016 ms at P=10240, C+1=65, bound by its bytes
    ([P, C1] read and written once, [C1] read once)."""
    t = roofline.cardinality_bound_s(10240, 65)
    assert t == pytest.approx(4 * (2 * 10240 * 65 + 65) / 3.35e12)
    assert t * 1e3 == pytest.approx(0.0016, abs=5e-5)
    assert (10240 * 65 * 66 + 2 * 10240 * 65) / 67e12 < t


def test_cardinality_share_from_a_trace():
    ops = [("void (anonymous namespace)::cardinality_predict_kernel(float "
            "const*, float const*, float*, int, int)", 0, 4_000),
           ("void (anonymous namespace)::cardinality_predict_kernel(float "
            "const*, float const*, float*, int, int)", 10_000, 16_000),
           ("void detect_kernel<4>(float const*)", 20_000, 30_000)]
    ctx = {"timeline": _window(ops), "shapes": dict(P=10240),
           "config": {"max_cardinality": 64},
           "traced": {"steps": 2, "z_counts": [30, 41]}}
    got = harness.load_reader("card.roofline_pct")(ctx)
    want = 100 * 2 * roofline.cardinality_bound_s(10240, 65) / 10e-6
    assert got == pytest.approx(want)
    assert 0 < got <= 100
    # a PHD cell: no such launch, and no max_cardinality
    ctx["timeline"] = _window(ops[2:])
    assert harness.load_reader("card.roofline_pct")(ctx) is None
    ctx["timeline"], ctx["config"] = _window(ops), {}
    assert harness.load_reader("card.roofline_pct")(ctx) is None
