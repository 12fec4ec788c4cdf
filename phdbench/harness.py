"""The benchmark's runner: one cell of ``BENCHMARK.json`` (a configuration
under a traffic mix) set up, driven for a window of whole episodes,
checked against the plain reference, and reduced to its metrics.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file that this module finds by name:
``configs/<config>.json`` (the configuration as it runs, its dataset, its
source and the limits of the check), ``traffic/<mix>.json`` (the mix's
parameters, read by :meth:`Cell.drive`) and ``metrics/<metric>.py`` (a
reader with ``read(ctx)``).

An episode is the configuration's whole log driven by a fresh filter: the
runner built once in set-up (the dataset read once), its state new and its
generator seeded with seed * 1000 + the episode's index. The window opens
at the first episode's start and closes at the end of the episode in
progress once the window's seconds have passed, so every step of every
episode counts.

A mix's file names the program's entry that drives an episode, its
``loop``: ``run``, one call of the program's own loop (``_Runner.run``
with its default chunk: the host runs ahead and waits once a chunk), or
``step``, which issues step n, reads its expected pose back to the host
and only then issues step n + 1, and times each step from issue to
readback.

The check: a sample of steps drawn from the seed (and the first step of
the first episode) copies its input state, draws and outputs to the host
as it runs; after the window the reference recomputes each from the same
inputs and gives the gaps, each held to its limit in the configuration's
file. The configuration's file names its reference, ``"reference":
"<module>"`` for ``reference/<module>.py`` (``step``, the static PHD
path, where it names none), which provides ``Settings.from_config``,
``initial_state``, ``step``, the precisions ``REFERENCE`` and
``CONTROL_TF32``, and the comparison: ``NAMES``, ``gaps``, ``init_gap``
and ``as_outputs``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import re
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "phdslam_tpu")

# the harness's own policy, the same in every cell
WARMUP_STEPS = 3        # steps the set-up runs through the mix's loop
CHECKS_PER_EPISODE = 1  # sampled steps an episode keeps for the check
MAX_CHECKS = 4          # sampled steps a run keeps (and the first step)
TRACE_SECONDS = 15.0    # the traced run profiles its first episodes so long
DEFAULT_REFERENCE = "step"
# filter-state fields that a step writes and never reads (the last step's
# ancestors, the map-variance estimate): the captures leave them out
WRITE_ONLY = ("resample_idx", "variance")


class NoDevice(RuntimeError):
    """The run found fewer cards than the cell asks for."""


def read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def manifest(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def load_cell(workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, with its configuration and traffic files read
    (``root``: the checkout's root)."""
    man = manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = dict(cells[workload])
    configs = {c["name"]: c for c in man["configs"]}
    cell["config_file"] = read_json(root / configs[cell["config"]]["file"])
    cell["traffic_file"] = read_json(root / BENCH.name / "traffic"
                                     / f"{cell['traffic']}.json")
    ref = cell["config_file"].get("reference", DEFAULT_REFERENCE)
    if not (isinstance(ref, str) and re.fullmatch(r"[A-Za-z_]\w*", ref)
            and (BENCH / "reference" / f"{ref}.py").is_file()):
        raise ValueError(f"configuration {cell['config']!r} names the "
                         f"reference module {ref!r}, which "
                         f"{BENCH.name}/reference/ does not hold")
    cell["reference"] = ref
    cell["run_seconds"] = man["run_seconds"]
    return cell


def cell_metrics(workload: str, section: str, root: Path = ROOT) -> list:
    """The names of the ``section`` metrics ("end_to_end" or "per_layer")
    that this cell reports: those without a ``workloads`` list and those
    whose list names it."""
    return [m["name"] for m in manifest(root)[section]
            if workload in m.get("workloads", [workload])]


def load_reader(name: str, root: Path = ROOT):
    """The reader of metric ``name``: ``metrics/<name>.py``'s ``read``."""
    path = root / BENCH.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "phdbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX package's or JAX's
    (compared whole: the port's name begins with the JAX package's)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def episode_seed(seed: int, e: int) -> int:
    return (seed * 1000 + e) % (1 << 63)


def state_tensors(state, skip=()) -> dict:
    """Every tensor field of a filter state that is not None, copied to the
    host, but for :data:`WRITE_ONLY` and ``skip``: ``map_static`` as
    ``mean``, ``cov`` and ``weight``, another map as ``<field>.mean`` and
    so on, any other tensor under its field's name."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is None or f.name in WRITE_ONLY or f.name in skip:
            continue
        if dataclasses.is_dataclass(v):
            pre = "" if f.name == "map_static" else f.name + "."
            out.update({pre + g.name: getattr(v, g.name).cpu()
                        for g in dataclasses.fields(v)})
        elif hasattr(v, "cpu"):
            out[f.name] = v.cpu()
    return out


def check_steps(seed: int, e: int, T: int, k: int) -> set:
    """The k steps of episode e that the check keeps, drawn from the seed;
    the first episode's first step too (the filter's starting state)."""
    rng = np.random.default_rng([seed % (1 << 63), e])
    picks = set(int(n) for n in rng.choice(np.arange(1, T), size=min(k,
                                           T - 1), replace=False))
    return picks | ({0} if e == 0 else set())


class Probe:
    """Wraps a runner's ``noise`` and ``step`` (instance attributes, so the
    program's loop calls them): host time spent issuing steps (the spans
    ``bench.noise`` and ``bench.step``) and the captures of the sampled
    steps, copied to the host as they run (so they hold no device
    memory)."""

    def __init__(self, runner, record):
        self.runner = runner
        self.record = record
        self.orig_step = runner.step
        self.orig_noise = runner.noise
        runner.step = self.step
        runner.noise = self.noise
        self.host_s = 0.0
        self.steps = 0
        self.want = set()
        self.episode = 0
        self.captures = []

    def noise(self):
        t = time.perf_counter()
        with self.record("bench.noise"):
            out = self.orig_noise()
        self.host_s += time.perf_counter() - t
        return out

    def step(self, n, noise=None):
        if noise is None:
            noise = self.runner.local_noise(self.noise())
        cap = self.capture_in(n, noise) if n in self.want else None
        t = time.perf_counter()
        with self.record("bench.step"):
            if cap is None:
                out = self.orig_step(n, noise)
            else:
                # what _Runner.step runs, with the log weights the
                # resampling read (phd_step's return_updated)
                r = self.runner
                r.state, out, lw_pre = r.step_state(
                    r.state, n, noise, r.mesh, return_updated=True)
        self.host_s += time.perf_counter() - t
        self.steps += 1
        if cap is not None:
            self.capture_out(cap, out, lw_pre)
        return out

    def capture_in(self, n, noise):
        z, zm, control, dt, do_predict, has_z = self.runner.step_args(n)
        return dict(
            episode=self.episode, step=n,
            inp=state_tensors(self.runner.state),
            args=dict(z=z.cpu(), z_mask=zm.cpu(),
                      control=tuple(float(c) for c in control),
                      dt=float(dt), do_predict=bool(do_predict),
                      has_z=bool(has_z)),
            noise=dict(eps=noise.eps_pred[0].cpu(),
                       u=noise.u_resample.cpu()))

    def capture_out(self, cap, out, lw_pre):
        """The step's outputs, the moments of every map (not the maps) and
        the state's further tensors (:func:`state_tensors`)."""
        import torch
        from .reference.step import map_moments
        st = self.runner.state
        gm = st.map_static
        # each map's moments in float64, in blocks of B maps so that their
        # temporaries stay small beside the program's own memory
        B = 1024
        cap["out"] = dict(
            pose=out.poses.cpu(), lw_pre=lw_pre.cpu(),
            log_weight=out.log_weight.cpu(),
            ancestors=out.resample_idx.cpu(),
            expected_pose=out.expected_pose.cpu(), n_eff=float(out.n_eff),
            resampled=bool(out.resampled),
            moments=torch.cat([map_moments(
                gm.mean[i:i + B], gm.cov[i:i + B], gm.weight[i:i + B]).cpu()
                for i in range(0, gm.weight.shape[0], B)]),
            map_moments=map_moments(out.map_mean, out.map_cov,
                                    out.map_weight).cpu())
        cap["out"].update(state_tensors(
            st, skip=("pose", "log_weight", "map_static")))
        self.captures.append(cap)


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat's start
    time against /proc/uptime); 0 where they cannot be read."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


class Cell:
    """One cell set up on a device: the program's configuration, its runner
    with the dataset read, the kernel library loaded, the step kinds warmed
    up."""

    def __init__(self, cell: dict, device: str = "cuda",
                 overrides: Optional[dict] = None,
                 checks: int = CHECKS_PER_EPISODE,
                 max_checks: int = MAX_CHECKS,
                 warmup_steps: int = WARMUP_STEPS):
        t = [time.perf_counter()]
        import torch
        from phdslam_tpu_torch.config import load_config
        from phdslam_tpu_torch.slam import SynthSLAMRunner
        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.cuda.init()
        t.append(time.perf_counter())
        self.cell = cell
        self.torch = torch
        cf = cell["config_file"]
        self.values = dict(cf["config"], **(overrides or {}))
        # the module load_cell found under reference/
        self.ref = importlib.import_module(
            f"{__package__}.reference.{cell['reference']}")
        self.settings = self.ref.Settings.from_config(self.values)
        self.cfg = load_config(os.devnull, dict(self.values))
        self.traffic = cell["traffic_file"]
        self.cold = None
        if self.device.type == "cuda":
            from phdslam_tpu_torch.kernels import build
            self.cold = not build.library_path().exists()
            build.library()
        t.append(time.perf_counter())
        self.runner = SynthSLAMRunner(self.cfg, str(ROOT / cf["data"]),
                                      device=self.device)
        t.append(time.perf_counter())
        self.T = self.runner.n_steps
        self.shapes = dict(P=self.cfg.n_particles, M=self.runner.m_max,
                           K=self.cfg.max_features,
                           T=self.cfg.detection_topk,
                           cap=self.cfg.merge_candidate_cap)
        # the valid measurements of each step that updates the map, in
        # step order (the roofline readers count the work by them)
        self.z_counts = []
        for n in range(self.T):
            _, zm, _, _, _, has_z = self.runner.step_args(n)
            if has_z:
                self.z_counts.append(int(zm.sum()))
        self.record = torch.profiler.record_function
        self.probe = Probe(self.runner, self.record)
        self.checks, self.max_checks = checks, max_checks
        self.sampled = 0
        self.warm_up(warmup_steps)
        t.append(time.perf_counter())
        self.setup_parts = dict(zip(
            ("program_imports", "kernel_library", "runner_and_data",
             "warm_up"), (b - a for a, b in zip(t, t[1:]))))

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def reset(self, seed: int):
        """A fresh filter for an episode: new state, generator reseeded."""
        from phdslam_tpu_torch.types import init_state
        self.runner.state = init_state(self.cfg, device=self.device)
        self.runner.generator.manual_seed(seed)

    def warm_up(self, n: int):
        """The cell's own step kinds (every step of these logs predicts and
        carries measurements), through the mix's own loop, then a sync."""
        self.reset(0)
        self.drive(min(n, self.T), [])
        self.sync()

    def drive(self, n: int, step_ms: list) -> int:
        """Steps 0 .. n - 1 on the runner's state, in the loop the mix's
        file names; returns the steps whose outputs were not finite, and
        (``step`` loop) appends each step's issue-to-readback ms."""
        loop = self.traffic["loop"]
        if loop == "run":
            T = self.runner.n_steps
            self.runner.n_steps = n
            try:
                bad = self.runner.run()["nan_step"]
            finally:
                self.runner.n_steps = T
            return 0 if bad is None else n - bad
        if loop != "step":
            raise ValueError(f"traffic loop {loop!r}: 'run' or 'step'")
        failed = 0
        for k in range(n):
            t0 = time.perf_counter()
            out = self.runner.step(k)
            with self.record("bench.readback"):
                pose = out.expected_pose.cpu()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            failed += int(not bool(self.torch.isfinite(pose).all()))
        return failed

    def episode(self, e: int, seed: int, step_ms: list) -> int:
        """Run episode e; returns the steps whose outputs were not finite."""
        self.probe.episode = e
        k = max(0, min(self.checks, self.max_checks - self.sampled))
        self.probe.want = check_steps(seed, e, self.T, k)
        self.sampled += k
        with self.record("bench.episode"):
            self.reset(episode_seed(seed, e))
            return self.drive(self.T, step_ms)

    def window(self, seed: int, seconds: float, tracer=None) -> dict:
        """Whole episodes until ``seconds`` have passed; the host clock
        around them, ending in a sync. A ``tracer`` (:class:`Tracer`)
        profiles the first of them."""
        step_ms, steps, failed, e = [], 0, 0, 0
        self.sampled = 0
        self.probe.host_s, self.probe.steps = 0.0, 0
        self.sync()
        t0 = time.perf_counter()
        with self.record("bench.window"):
            if tracer:
                tracer.start()
            while True:
                failed += self.episode(e, seed, step_ms)
                steps += self.T
                e += 1
                elapsed = time.perf_counter() - t0
                if tracer:
                    tracer.after_episode(elapsed, steps, e)
                if elapsed >= seconds:
                    break
            self.sync()
            if tracer:
                tracer.stop(steps, e)
        t1 = time.perf_counter()
        return dict(seconds=t1 - t0, steps=steps, episodes=e, failed=failed,
                    step_ms=step_ms, host_s=self.probe.host_s,
                    host_steps=self.probe.steps)

    def release(self):
        """Free the program's state on the card before the check runs."""
        self.runner.state = None
        self.runner = None
        self.probe.runner = None
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def check(self, controls: bool = False) -> dict:
        """The reference over every capture: the largest gap of each
        number (None where no step had one), and (with ``controls``) the
        control's gaps on the same inputs, computed in TF32 in the
        program's place: the cell's reference module's (:func:`load_cell`).
        """
        ref, s = self.ref, self.settings
        worst = dict.fromkeys(ref.NAMES)
        ctrl = dict.fromkeys(ref.NAMES) if controls else None
        for cap in self.probe.captures:
            if cap["episode"] == 0 and cap["step"] == 0:
                _worse(worst, {"init": ref.init_gap(s, cap["inp"])})
                if controls:
                    prior = ref.initial_state(s)
                    _worse(ctrl, {"init": ref.init_gap(s, {
                        k: ref.CONTROL_TF32(v) for k, v in prior.items()})})
            a = cap["args"]
            call = (a["z"], a["z_mask"], a["control"], a["dt"],
                    a["do_predict"], a["has_z"], cap["noise"]["eps"],
                    cap["noise"]["u"])
            want = ref.step(s, cap["inp"], *call, q=ref.REFERENCE,
                            device=self.device)
            _worse(worst, ref.gaps(s, cap["out"], want))
            if controls:
                got = ref.step(s, cap["inp"], *call, q=ref.CONTROL_TF32,
                               device=self.device)
                _worse(ctrl, ref.gaps(
                    s, ref.as_outputs(got, ref.CONTROL_TF32), want))
            del want
        return dict(gaps=worst, control=ctrl,
                    checked=len(self.probe.captures))


def _worse(acc: dict, new: dict) -> None:
    """Keep the largest reading of each number (NaN counts as infinite)."""
    for k, v in new.items():
        if v is None:
            continue
        v = v if v == v else math.inf
        acc[k] = v if acc.get(k) is None else max(acc[k], v)


class Tracer:
    """``torch.profiler`` over the window's first whole episodes: from the
    window's start to the end of the episode in progress once
    ``seconds`` have passed (:data:`TRACE_SECONDS`), inside
    the range ``bench.traced``; the rest of the window runs unprofiled, so
    the trace, and the time to read it, stay bounded. ``traced`` holds the
    steps and host counters of the profiled part."""

    def __init__(self, torch, probe, seconds: float):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.range = torch.profiler.record_function("bench.traced")
        self.probe, self.seconds = probe, seconds
        self.traced = None

    def start(self):
        self.prof.__enter__()
        self.range.__enter__()

    def after_episode(self, elapsed: float, steps: int, episodes: int):
        if elapsed >= self.seconds:
            self.stop(steps, episodes)

    def stop(self, steps: int, episodes: int):
        """Close the range and the profiler after an episode (which ends in
        a sync: its device work is in the trace)."""
        if self.traced is not None:
            return
        self.range.__exit__(None, None, None)
        self.traced = dict(steps=steps, episodes=episodes,
                           host_s=self.probe.host_s,
                           host_steps=self.probe.steps)
        self.prof.__exit__(None, None, None)


def verdict(gaps: dict, limits: dict) -> dict:
    """Each number the configuration sets a limit for, beside its limit:
    over the limit, or not finite, fails; no reading (no step had one,
    such as ancestors where no checked step resampled) passes."""
    out = {}
    for name, lim in limits.items():
        value = gaps.get(name)
        ok = value is None or (math.isfinite(value) and value <= lim)
        out[name] = {"value": value, "limit": lim, "ok": ok}
    return out


def device_info(torch, device) -> dict:
    return {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": 1}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", overrides: Optional[dict] = None,
        t_start: Optional[float] = None, log=print) -> dict:
    """One run of a cell: set-up, window, check, metrics. Returns the
    result object (the last line the command prints). ``t_start`` is the
    host clock when the process began (``setup_s`` counts from it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(workload)
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < int(cell["chips"]):
            raise NoDevice(f"{workload} needs {cell['chips']} CUDA "
                           f"device(s); found "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_cell = time.perf_counter()
    bench = Cell(cell, device, overrides)
    setup_s = time.perf_counter() - t_start
    if dev.type == "cuda":
        log(f"[phdbench] {workload} seed {seed}: "
            f"{power_limit()}, kernel library "
            f"{'cold (built in this run)' if bench.cold else 'warm'}, "
            f"set-up {setup_s:.3f} s: interpreter, torch and the CUDA "
            f"context {t_cell - t_start:.3f}, " + ", ".join(
                f"{k} {v:.3f}" for k, v in bench.setup_parts.items()))

    tracer = None
    if trace and dev.type == "cuda":
        tracer = Tracer(torch, bench.probe, TRACE_SECONDS)
    win = bench.window(seed, seconds, tracer)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    log(f"[phdbench] window {win['seconds']:.3f} s, {win['episodes']} "
        f"episodes, {win['steps']} steps, peak memory {peak} bytes")

    ctx = dict(window=win, setup_s=setup_s, shapes=bench.shapes,
               config=bench.values, timeline=None, traced=None)
    dev_info = device_info(torch, dev)
    dev_info["memory_peak_bytes"] = int(peak)
    breakdown = None
    if tracer is not None:
        from .trace import timeline
        tl = timeline(tracer.prof, "bench.traced")
        ctx["traced"] = dict(tracer.traced, z_counts=(
            bench.z_counts * tracer.traced["episodes"]))
        tracer = None
        ctx["timeline"] = tl
        dev_info["busy_s"] = tl.busy_ns() * 1e-9
        dev_info["window_s"] = tl.window_s
        breakdown = tl.breakdown()
        log(f"[phdbench] trace: {ctx['traced']['steps']} steps, "
            f"{len(tl.ops)} device operations, layers (ms) "
            f"{ {k: v * 1e-6 for k, v in tl.layer_ns.items()} }")

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    units = {m["name"]: m["unit"] for m in manifest()[section]}
    for name in cell_metrics(workload, section):
        value = load_reader(name)(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    ctx = None

    bench.release()
    limits = cell["config_file"].get("limits", {})
    chk = bench.check()
    checks = verdict(chk["gaps"], limits)
    correct = (win["failed"] == 0 and chk["checked"] > 0 and bool(checks)
               and all(c["ok"] for c in checks.values()))
    result = {"correct": correct, "attempted": win["steps"],
              "failed": win["failed"], "metrics": metrics,
              "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    log(f"[phdbench] {chk['checked']} steps checked against the reference")
    result["check"] = {k: {"value": v["value"], "limit": v["limit"]}
                       for k, v in checks.items()}
    return result
