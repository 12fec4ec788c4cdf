"""The port's spans and counters (``runtime/profiling.py``): off, a span is
the shared no-op and opens no profiler range; on, each span's count, self
time and parents follow its nesting, its interval lines up with its
profiler copy, the runner's spans and device-side work counts read what
the state holds, and tracing changes no output bit."""

import gc
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from phdslam_tpu_torch import load_config
from phdslam_tpu_torch.eval import batch
from phdslam_tpu_torch.filters.phd import _log_count
from phdslam_tpu_torch.ops.resample import particle_row
from phdslam_tpu_torch.runtime import profiling
from phdslam_tpu_torch.slam import SynthSLAMRunner

PORT = Path(__file__).resolve().parents[1] / "phdslam_tpu_torch"
# the layer spans the port had before the runner, kernel, host-sync and
# collection spans (the trace readers key on the phd. prefix)
LAYER_SPANS = {"phd.predict", "phd.pre", "phd.gather", "phd.merge",
               "phd.variance", "phd.post", "phd.extract_resample",
               "cphd.pre", "cphd.card", "cphd.births", "disp.pre",
               "disp.compact", "disp.merge", "disp.post", "disp.predict",
               "disp.resample_extract"}
NEW_KINDS = ("runner.", "kernel.", "sync.", "host.")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trace"))
    batch.generate_batch_datasets(root, n_runs=1, n_landmarks=15, n_steps=30,
                                  seed=11)
    return root + "/run000"


def runner(data_dir, n_steps=3):
    cfg = load_config("cfg/ackerman.cfg", dict(
        n_particles=8, max_features=32, max_measurements=16,
        detection_topk=8, merge_candidate_cap=64, particle_weighting=0,
        n_steps=n_steps))
    return SynthSLAMRunner(cfg, data_dir, device="cpu")


class FakeClock:
    """``profiling.time`` with a clock the test moves."""

    def __init__(self):
        self.now = 0

    def perf_counter_ns(self):
        return self.now

    def time_ns(self):
        return 10 ** 18 + self.now


@pytest.mark.parametrize("open_span", [
    lambda: profiling.span("phd.pre"), lambda: profiling.span("runner.step"),
    lambda: profiling.kernel("detect"), lambda: profiling.host_sync("has_z")],
    ids=["layer", "runner", "kernel", "host_sync"])
def test_off_span_is_the_shared_no_op(open_span):
    assert profiling._trace is None
    before = dict(profiling.sync_counts)
    s = open_span()
    assert s is profiling._OFF
    with s:
        pass
    with pytest.raises(KeyError):         # an exception passes through
        with open_span():
            raise KeyError("x")
    grown = {k for k in profiling.sync_counts
             if profiling.sync_counts[k] != before.get(k, 0)}
    assert grown <= {"has_z"}


def test_profiled_span_is_a_range_of_its_kind():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        layer = profiling.span("phd.pre")
        host = profiling.span("runner.step")
        with layer, host:
            torch.ones(2).sum()
    assert isinstance(layer, torch.profiler.record_function)
    assert isinstance(host, torch._C._profiler._RecordFunctionFast)
    scopes = {e.name(): e.scope() for e in
              prof.profiler.kineto_results.events()}
    # a user range (drawn on the device timeline too) for the layer span,
    # a function-scope host range for the other
    assert scopes["phd.pre"] != scopes["runner.step"] == 0


def test_counts_and_self_time_follow_nesting(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(profiling, "time", clock)
    with profiling.tracing() as tr:
        with profiling.span("runner.step"):           # 0 .. 100
            clock.now = 10
            with profiling.span("phd.pre"):           # 10 .. 30
                clock.now = 15
                with profiling.kernel("detect"):      # 15 .. 25
                    clock.now = 25
                clock.now = 30
            clock.now = 40
            with profiling.span("phd.pre"):           # 40 .. 45
                clock.now = 45
            clock.now = 100
        snap = tr.snapshot()
    ns = {name: (st["count"], round(st["incl_ms"] * 1e6),
                 round(st["self_ms"] * 1e6), st["parents"])
          for name, st in snap["spans"].items()}
    assert ns == {"runner.step": (1, 100, 75, {"": 1}),
                  "phd.pre": (2, 25, 15, {"runner.step": 2}),
                  "kernel.detect": (1, 10, 10, {"phd.pre": 1})}
    assert [i[1:] for i in tr.intervals] == [
        (10 ** 18 + 15, 10 ** 18 + 25), (10 ** 18 + 10, 10 ** 18 + 30),
        (10 ** 18 + 40, 10 ** 18 + 45), (10 ** 18, 10 ** 18 + 100)]
    tr.reset()
    assert tr.snapshot()["spans"] == {}


def test_tracing_is_not_reentrant():
    with profiling.tracing():
        with pytest.raises(RuntimeError):
            with profiling.tracing():
                pass
    assert profiling._trace is None


def traced_offsets(names):
    """Three traced steps under a CPU profiler: each span's in-memory
    interval against its profiler copy, as the (start, end) differences."""
    def steps(n):
        for _ in range(n):
            with profiling.span("runner.step"):
                with profiling.span("phd.pre"):
                    torch.ones(64).cumsum(0)
                    with profiling.kernel("detect"):
                        time.sleep(0.001)
                with profiling.span("phd.merge"):
                    torch.ones(64).sort()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        # a process's first profiler ranges pay a one-off set-up: warm
        # them before the timed ones; and a collection inside a span's
        # exit would end its copy that much later: this checks the clocks
        steps(1)
        gc.disable()
        try:
            with profiling.tracing() as tr:
                steps(3)
        finally:
            gc.enable()
    copies = {n: [] for n in names}
    for e in prof.profiler.kineto_results.events():
        if e.name() in copies:
            copies[e.name()].append((e.start_ns(), e.end_ns()))
    mine = {n: [] for n in names}
    for name, lo, hi in tr.intervals:
        mine[name].append((lo, hi))
    out = {}
    for n in names:
        theirs = sorted(copies[n])[1:]                  # past the warm-up
        assert len(mine[n]) == len(theirs) == 3, n
        out[n] = [(lo - klo, hi - khi)
                  for (lo, hi), (klo, khi) in zip(sorted(mine[n]), theirs)]
    return out


def test_intervals_line_up_with_the_profiler_copy():
    """Within 50 us, in one of three tries: the host thread, preempted
    between a clock read and its copy's, would read that much apart."""
    names = ["runner.step", "phd.pre", "kernel.detect", "phd.merge"]
    for _ in range(3):
        offsets = traced_offsets(names)
        worst = max(abs(d) for n in names for pair in offsets[n]
                    for d in pair)
        if worst < 50_000:
            break
    assert worst < 50_000, offsets


def test_host_sync_and_collections_counted():
    with profiling.tracing() as tr:
        with profiling.host_sync("site_a"):
            pass
        gc.collect()
        snap = tr.snapshot()
    assert snap["counters"]["syncs"] == {"site_a": 1}
    assert snap["spans"]["sync.site_a"]["count"] == 1
    assert snap["counters"]["gc"]["collections"] >= 1
    assert snap["spans"]["host.gc"]["count"] >= 1


def test_runner_spans_and_work_counts(data_dir):
    r = runner(data_dir)
    live, updates = [], []
    step_state = r.step_state

    def watched(state, n, *args, **kwargs):
        updates.append(r.step_args(n)[5])
        live.append(int((state.map_static.weight > 0).sum()))
        return step_state(state, n, *args, **kwargs)
    r.step_state = watched
    with profiling.tracing() as tr:
        r.run(chunk=2)
        snap = tr.snapshot()
    spans, work = snap["spans"], snap["work"]
    P, n_up = r.cfg.n_particles, sum(updates)
    assert n_up >= 2
    assert spans["runner.step"]["count"] == spans["runner.noise"]["count"] == 3
    assert spans["phd.pre"]["count"] == n_up
    assert spans["phd.pre"]["parents"] == {"runner.step": n_up}
    assert spans["runner.wait"]["count"] == 2          # a wait a chunk
    assert work["map.live_components"] == dict(
        sum=sum(v for v, u in zip(live, updates) if u), count=P * n_up)
    for name in ("merge.entering_lanes", "merge.clusters", "select.dropped"):
        assert work[name]["count"] == P * n_up, name
    assert 0 < work["merge.clusters"]["sum"] <= \
        work["merge.entering_lanes"]["sum"] <= 64 * P * n_up
    # the MAP row and log P stay on the device: a single-device run given
    # has_z by its schedule (and tiling nothing) waits for the card nowhere
    # inside a step, least of all in the step's tail
    assert snap["counters"]["syncs"] == {}
    for name, s in spans.items():
        if name.startswith("sync."):
            assert "phd.extract_resample" not in s["parents"], name
    assert snap["counters"]["launches"] == {}    # CPU: the twins run


@pytest.mark.parametrize("shape", [(), (6,), (6, 2)],
                         ids=["1d", "2d", "3d"])
def test_particle_row_is_the_same_bits_as_indexing(shape):
    """The device gather of the MAP row gives ``x[int(i)]``'s bits for a
    1-D, 2-D and 3-D leaf, with ``i`` a 0-dim argmax; on a tie the
    argmax, and so the row, is the lowest index's."""
    g = torch.Generator().manual_seed(5)
    P = 9
    x = torch.randn((P,) + shape, generator=g, dtype=torch.float64)
    n = torch.randint(0, 100, (P,) + shape, generator=g)
    for log_w in (torch.randn(P, generator=g),
                  torch.tensor([0.1, -2.0, 0.7, 0.3, 0.7, -1.0, 0.7, 0.0,
                                0.2])):
        i = torch.argmax(log_w)
        assert i.dim() == 0
        got_x, got_n = particle_row(i, [x, n])
        assert got_x.shape == x.shape[1:] and got_n.dtype == n.dtype
        bits = torch.int64
        assert torch.equal(got_x.view(bits), x[int(i)].view(bits))
        assert torch.equal(got_n, n[int(i)])
    assert int(i) == 2                  # the tie at 2, 4 and 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("n", [1, 3, 512, 10240, 30720])
def test_log_count_is_the_same_bits_and_kept(n, dtype):
    """log n as the step makes it (a fill and a log on the device) has
    ``torch.log``'s bits of ``float(n)`` copied there, and is made once
    per (n, dtype, device): a later call returns the same tensor."""
    like = torch.zeros(4, dtype=dtype)
    got = _log_count(n, like)
    want = torch.log(torch.tensor(float(n), dtype=dtype))
    assert got.dtype == dtype and got.dim() == 0
    assert got.device == like.device
    assert torch.equal(got, want)
    assert _log_count(n, like[:1]) is got


def test_tracing_changes_no_output_bit(data_dir):
    kw = dict(chunk=2, collect_maps=True, collect_particles=True)
    plain = runner(data_dir, n_steps=4).run(**kw)
    with profiling.tracing():
        traced = runner(data_dir, n_steps=4).run(**kw)
    for key in ("est_poses", "n_eff", "log_weights", "poses", "resample_idx",
                "map_means", "map_weights", "map_covs"):
        np.testing.assert_array_equal(traced[key], plain[key], err_msg=key)


def test_span_names_keep_the_layer_prefixes(data_dir):
    """No new span takes a prefix the trace readers key on (``phd.``,
    ``bench.``): every name in the port's source and in a traced run is a
    layer span it had or one of the new kinds."""
    literal = re.compile(
        r"profiling\.(span|kernel|host_sync)\(\s*\"([^\"]+)\"")
    found = set()
    for path in PORT.rglob("*.py"):
        for kind, name in literal.findall(path.read_text()):
            found.add(name if kind == "span" else
                      ("kernel." if kind == "kernel" else "sync.") + name)
    with profiling.tracing() as tr:
        runner(data_dir, n_steps=2).run()
        gc.collect()
        found |= set(tr.snapshot()["spans"])
    assert {"runner.step", "runner.noise", "runner.wait", "host.gc",
            "sync.tile_width", "phd.pre"} <= found
    for name in found:
        assert not name.startswith("bench."), name
        assert name in LAYER_SPANS or name.startswith(NEW_KINDS), name


def test_timed_steps_leave_the_prediction_out(data_dir, monkeypatch):
    """``run(timing=True)``'s step_ms times the step alone: the prediction
    replayed before it (here held 0.4 s longer) is in predict_ms only."""
    r = runner(data_dir)
    predict_only = r.predict_only

    def slow(n, noise):
        time.sleep(0.4)
        return predict_only(n, noise)
    monkeypatch.setattr(r, "predict_only", slow)
    res = r.run(timing=True)
    assert res["predict_ms"].max() >= 400
    assert res["step_ms"].max() < 400, res["step_ms"]


def test_spans_of_another_thread_are_not_recorded():
    import threading

    def other():
        with profiling.span("runner.step"):
            pass
    with profiling.tracing() as tr:
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with profiling.span("runner.noise"):
            pass
        assert set(tr.snapshot()["spans"]) <= {"runner.noise", "host.gc"}
