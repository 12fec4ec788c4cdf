"""Per-layer readings from the program's own spans and counters, and the
profiled episodes read by launch: one cell run as ``run.py --trace 1``
runs it (the same set-up, window and profiled first episodes), with the
program's tracing (``runtime/profiling.py``) turned on for the unprofiled
rest of the window.

    python3 phdbench/spans.py --workload dense-phd.replay --seed 7 \\
        --seconds 45 --out runs/spans_dense_replay.json

The last line of standard output is one JSON object: ``metrics`` (each
reading named as the benchmark would name it in this cell, a ``.host_paced``
twin in the Ackerman cells), ``launches`` (the profiled window's device ms
by the innermost span that launched them, the harness's share, the
unmatched share and how each operation was matched), ``gaps`` (the ten
longest idle gaps: span, host state, ms, the host operation open when
each began), ``spans`` and ``work`` (the
unprofiled steps' snapshot), ``on_rate`` (the unprofiled, traced steps a
second, to set beside a ``--trace 0`` run's ``steps_per_s``) and
``accepted`` (the benchmark's own per-layer readings of the same trace).
With ``--profile 0`` nothing is profiled and the program's tracing runs
for the whole window. The run checks nothing against the reference:
``run.py`` does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("OMP_NUM_THREADS", "1")


def readings(snap: dict, la, traced_steps: int) -> dict:
    """The new per-layer metrics: host ms a step from the unprofiled steps'
    spans, mean work counts from their device-side counts, and device ms a
    step by launching span and the blocked idle share from the profiled
    window (``la``: :class:`launches.Launches`)."""
    spans, work = snap["spans"], snap["work"]
    out = {}
    n = spans.get("runner.step", {}).get("count", 0)
    if n:
        incl = {k: spans.get(k, {}).get("incl_ms", 0.0)
                for k in ("runner.noise", "runner.step", "phd.pre")}
        out["runner.issue_ms"] = (incl["runner.noise"]
                                  + incl["runner.step"]) / n
        out["pre.host_ms"] = incl["phd.pre"] / n
    for metric, count in (("map.live_components", "map.live_components"),
                          ("merge.entering_lanes", "merge.entering_lanes")):
        w = work.get(count)
        if w and w["count"]:
            out[metric] = w["sum"] / w["count"]
    if la is not None and traced_steps:
        for metric, span in (("pre.launched_device_ms", "phd.pre"),
                             ("merge.launched_device_ms", "phd.merge")):
            if span in la.inside_ns:
                out[metric] = la.inside_ns[span] * 1e-6 / traced_steps
        w_ns = la.window_ns[1] - la.window_ns[0]
        if w_ns > 0:
            out["device.idle_blocked_pct"] = 100.0 * la.gap_ns(True) / w_ns
    return out


def launch_summary(la, tl, traced_steps: int) -> dict:
    """The profiled window's device time by launching span (ms a step),
    the harness's and the unmatched shares, and how operations matched."""
    total = la.total_ns
    parts = sum(la.innermost_ns.values()) + la.outside_ns + la.unmatched_ns
    return {
        "total_ms": total * 1e-6, "ops": la.n_ops,
        "innermost_ms_a_step": {k: v * 1e-6 / traced_steps for k, v in
                                sorted(la.innermost_ns.items())},
        "inside_ms_a_step": {k: v * 1e-6 / traced_steps for k, v in
                             sorted(la.inside_ns.items())},
        "outside_ms": la.outside_ns * 1e-6,
        "unmatched_ms": la.unmatched_ns * 1e-6,
        "unmatched_ops": la.n_unmatched,
        "unmatched_share": la.n_unmatched / max(1, la.n_ops),
        "parts_over_total": parts / total if total else None,
        "matched_by": la.matched_by,
        "idle_pct": 100.0 * (1.0 - tl.busy_ns() * 1e-9 / tl.window_s),
        "calls_a_step": {span: {call: [n / traced_steps,
                                       ns * 1e-6 / traced_steps]
                                for call, (n, ns) in sorted(calls.items())}
                         for span, calls in sorted(la.calls.items())},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None, help="also write the JSON here")
    p.add_argument("--profile", type=int, choices=(0, 1), default=1,
                   help="0: no profile; the program's tracing runs for the "
                        "whole window (its on-cost against --trace 0)")
    p.add_argument("--device", default="cuda",
                   help="cpu: a rehearsal of the tool (with --particles)")
    p.add_argument("--particles", type=int, default=None,
                   help="n_particles in place of the configuration's")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from phdbench import harness, launches, trace
    from phdslam_tpu_torch.runtime import profiling

    class Tracer(harness.Tracer):
        """The harness's tracer; once the profile stops, the program's
        tracing runs for the rest of the window."""
        tracing = trace_on = None

        def stop(self, steps, episodes):
            if self.traced is not None:
                return
            super().stop(steps, episodes)
            self.tracing = profiling.tracing()
            self.trace_on = self.tracing.__enter__()
            self.on = (time.perf_counter(), steps, self.probe.host_s,
                       self.probe.steps)

    cell = harness.load_cell(args.workload)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("[spans] no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    bench = harness.Cell(cell, args.device, overrides=(
        None if args.particles is None else {"n_particles": args.particles}))
    print(f"[spans] {args.workload} seed {args.seed}: {harness.power_limit()}"
          f", set-up {time.perf_counter() - t0:.3f} s", flush=True)
    suffix = ("" if "steps_per_s" in harness.cell_metrics(
        args.workload, "end_to_end") else ".host_paced")
    result = {"workload": args.workload, "seed": args.seed,
              "device": (torch.cuda.get_device_name(0)
                         if args.device == "cuda" else args.device),
              "power": harness.power_limit(), "profile": args.profile}
    la = None
    traced_steps = 0
    if args.profile:
        tracer = Tracer(torch, bench.probe, harness.TRACE_SECONDS)
        win = bench.window(args.seed, args.seconds, tracer)
        t_end = time.perf_counter()
        snap = tracer.trace_on.snapshot()
        tracer.tracing.__exit__(None, None, None)
        t_on, steps_before, host_s0, host_steps0 = tracer.on
        t_read = time.perf_counter()
        evs = launches.events(tracer.prof)
        tl = trace.from_events(((e.name, e.on_device, e.start, e.end)
                                for e in evs), "bench.traced")
        la = launches.read(evs, "bench.traced")
        evs = None
        traced_steps = tracer.traced["steps"]
        print(f"[spans] trace read in {time.perf_counter() - t_read:.1f} s:"
              f" {traced_steps} profiled steps, {la.n_ops} device "
              f"operations", flush=True)
        ctx = dict(window=win, setup_s=0.0, shapes=bench.shapes,
                   config=bench.values, timeline=tl,
                   traced=dict(tracer.traced, z_counts=(
                       bench.z_counts * tracer.traced["episodes"])))
        result["accepted"] = {}
        for name in harness.cell_metrics(args.workload, "per_layer"):
            value = harness.load_reader(name)(ctx)
            if value is not None:
                result["accepted"][name] = value
        result["launches"] = launch_summary(la, tl, traced_steps)
        result["gaps"] = la.longest_gaps(10)
    else:
        with profiling.tracing() as tr:
            t_on, steps_before, host_s0, host_steps0 = (
                time.perf_counter(), 0, 0.0, 0)
            win = bench.window(args.seed, args.seconds)
            t_end = time.perf_counter()
            snap = tr.snapshot()
    steps_on = win["steps"] - steps_before
    host_steps = win["host_steps"] - host_steps0
    result.update(
        metrics={k + suffix: v for k, v in
                 readings(snap, la, traced_steps).items()},
        on_rate=steps_on / (t_end - t_on), on_steps=steps_on,
        bench_host_ms_traced=(1e3 * (win["host_s"] - host_s0) / host_steps
                              if host_steps else None),
        window={k: win[k] for k in ("seconds", "steps", "episodes",
                                    "failed")},
        spans=snap["spans"], work=snap["work"], counters=snap["counters"])
    for g in result.get("gaps", []):
        print(f"[spans] gap {g[2]:.3f} ms in {g[0]} (host: {g[1]}, {g[3]})")
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
