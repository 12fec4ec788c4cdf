"""Timing, spans, counters, tracing and the NaN checks (port of
``phdslam_tpu/runtime/profiling.py``, with the port's own spans and
counters).

* the prediction's own time -> ``predicttime.log``: :func:`timed_call`
  waits for the card before it reads the clock (the runners time each
  step themselves for ``loopTime.log``).
* :func:`span`: a named stretch of host code at a layer boundary. Layer
  spans (names starting with :data:`LAYER_PREFIXES`: ``phd.*``,
  ``cphd.*``, ``disp.*``) are user ranges for ``torch.profiler``, which
  also draws them on the device timeline over the kernels launched inside
  them; every other span (``runner.*``, ``kernel.*``, ``sync.*``,
  ``host.gc``) is a host range only, linked to what it launches by the
  launch's correlation. :func:`kernel` is the span of a hand-kernel launch
  (``kernel.<name>``), :func:`host_sync` the span of a transfer inside a
  step that waits for the card (``sync.<site>``, counted in
  :data:`sync_counts`), and
  every garbage collection runs inside ``host.gc`` (counted in
  :data:`gc_counts`).
* Off (the default): a span enters a profiler range only while a
  ``torch.profiler`` is active; otherwise it reads no clock and allocates
  nothing.
* :func:`tracing` (on): each span also records its count, inclusive and
  self time (its time minus its child spans') and its parents, in memory,
  on the profiler's clock; :func:`add` keeps device-side work counts. The
  trace's ``snapshot()`` / ``reset()`` take the spans of a stretch of
  steps.
* counters (:data:`counters`): hand-kernel launches (:data:`launch_counts`,
  also ``kernels.build.launch_counts``), host syncs by site, garbage
  collections and their ms, always on.
* :func:`trace`: ``torch.profiler`` (CPU and, with a card, CUDA activity)
  and :func:`tracing` around a block; writes ``trace.json`` (Chrome trace)
  and ``spans.json`` into a directory.
* :func:`debug_mode`: the runners check every step for NaN weights and
  raise ``FloatingPointError`` at the first (without it they report the
  first NaN step after the run and return). It does not switch on
  ``torch.autograd.detect_anomaly``: that guards backward passes, and the
  filter has none.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import gc
import json
import os
import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler

_NAN_CHECKS = contextvars.ContextVar("nan_checks", default=False)

# spans whose profiler copy is a user range (drawn on the device timeline
# too); the trace readers attribute device work to these names
LAYER_PREFIXES = ("phd.", "cphd.", "disp.")

# launches per hand kernel since the last reset: each wrapper adds one
# where it launches its kernel (never for a CPU tensor that runs the twin)
launch_counts: collections.Counter = collections.Counter()
# transfers inside a step that wait for the card, by site (:func:`host_sync`)
sync_counts: collections.Counter = collections.Counter()
# garbage collections ("collections") and the host ms they took ("ms")
gc_counts: collections.Counter = collections.Counter()
counters = {"launches": launch_counts, "syncs": sync_counts,
            "gc": gc_counts}


def nan_checks() -> bool:
    """True inside :func:`debug_mode`."""
    return _NAN_CHECKS.get()


def synchronize() -> None:
    """Wait for the card's queued work (nothing to wait for when the
    process never touched a card)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed_call(fn, *args, **kwargs):
    """Run fn, wait for its outputs on the card, return (result,
    elapsed_ms): the predicttime.log pattern."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    synchronize()
    return out, (time.perf_counter() - t0) * 1000.0


# ----------------------------------------------------------------------------
# spans
# ----------------------------------------------------------------------------

class _Off:
    """The span of a stretch that is neither traced nor profiled. Its enter
    and exit are C functions, so a ``with`` on it runs no Python frame:
    ``int()`` and ``"".format(exc_type, exc, tb)``, whose empty string is
    false, so an exception propagates."""
    __slots__ = ()
    __enter__ = int
    __exit__ = "".format


_OFF = _Off()
_trace: Optional["Trace"] = None       # the trace while tracing() is on


def _profiled() -> bool:
    return _autograd_profiler._is_profiler_enabled


def _range(name: str):
    """A span's copy in an active ``torch.profiler``: a user range for a
    layer span, a host range (no device range) for any other."""
    if name.startswith(LAYER_PREFIXES):
        return torch.profiler.record_function(name)
    return torch._C._profiler._RecordFunctionFast(name)


def _open(name: str):
    return _trace.span(name) if _trace is not None else _range(name)


def span(name: str):
    """The span ``name`` around a block (``with profiling.span(...)``)."""
    if _trace is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _open(name)


def kernel(name: str):
    """The span ``kernel.<name>`` around the launch of a hand kernel counted
    as ``name`` in :data:`launch_counts`."""
    if _trace is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _open("kernel." + name)


def host_sync(site: str):
    """The span ``sync.<site>`` around a transfer inside a step that waits
    for the card (a device-to-host read, or a copy that synchronizes the
    stream), counted in :data:`sync_counts`. The sites: ``tile_width``
    (a tiled capped route's widths, ``filters/phd.py::TileRoute``),
    ``has_z`` (a step not given it), ``resample`` (a mesh's resampling
    decision) and ``migrate_feasible`` (``parallel/migrate.py``). A
    single-device step that tiles nothing and is given ``has_z`` has
    none: its MAP row and log P stay on the device."""
    sync_counts[site] += 1
    if _trace is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _open("sync." + site)


def add(name: str, value, n: int) -> None:
    """While tracing: add the sum of ``value`` (a tensor, or a function
    returning one, called only then) to the device-side work count
    ``name``, and ``n`` (the particle-updates or particle-merges it sums
    over) to its count. Off, nothing is computed."""
    if _trace is not None:
        _trace.add(name, value() if callable(value) else value, n)


class _Span:
    """A span while tracing: its profiler copy (under an active profiler)
    and its record in the trace."""
    __slots__ = ("trace", "name", "copy", "t0", "child")

    def __init__(self, trace: "Trace", name: str):
        self.trace, self.name = trace, name

    def __enter__(self):
        self.copy = _range(self.name) if _profiled() else None
        if self.copy is not None:
            self.copy.__enter__()
        self.child = 0
        self.trace.stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        # the copy's clock reads inside its enter and exit: this span's
        # interval runs from its copy's enter to past its exit
        if self.copy is not None:
            self.copy.__exit__(exc_type, exc, tb)
        self.trace.close(self, time.perf_counter_ns())
        return False


class Trace:
    """The spans and device-side work counts recorded while
    :func:`tracing` is on, from the thread that turned it on. Span times
    are on the profiler's clock: ``perf_counter_ns`` plus ``offset``
    (epoch nanoseconds, taken when tracing starts)."""

    def __init__(self):
        self.thread = threading.get_ident()
        self.offset = time.time_ns() - time.perf_counter_ns()
        self.stack = []
        self.reset()

    def reset(self) -> None:
        """Forget what was recorded so far (the counters count from here)."""
        self.stats = {}          # name -> [count, inclusive ns, self ns]
        self.parents = {}        # name -> Counter of the enclosing spans
        self.intervals = []      # (name, start, end) on the profiler clock
        self.work = {}           # name -> [device sum, count]
        self.base = {k: collections.Counter(c) for k, c in counters.items()}

    def span(self, name: str):
        """The span's record, or on another thread its profiler copy only."""
        if threading.get_ident() != self.thread:
            return _range(name) if _profiled() else _OFF
        return _Span(self, name)

    def close(self, s: _Span, t1: int) -> None:
        stack = self.stack
        stack.pop()
        dur = t1 - s.t0
        parent = stack[-1].name if stack else ""
        if stack:
            stack[-1].child += dur
        st = self.stats.get(s.name)
        if st is None:
            st = self.stats[s.name] = [0, 0, 0]
            self.parents[s.name] = collections.Counter()
        st[0] += 1
        st[1] += dur
        st[2] += dur - s.child
        self.parents[s.name][parent] += 1
        self.intervals.append((s.name, s.t0 + self.offset,
                               t1 + self.offset))

    def add(self, name: str, value: torch.Tensor, n: int) -> None:
        acc = self.work.get(name)
        total = value.sum(dtype=torch.int64)
        if acc is None:
            self.work[name] = [total, n]
        else:
            acc[0] = acc[0] + total
            acc[1] += n

    def snapshot(self) -> dict:
        """What was recorded since the last reset: each span's count,
        inclusive and self ms and parents (``""``: outermost), the
        counters' growth, and each work count's sum and count (the device
        sums read here, in one read)."""
        sums = (torch.stack([a[0] for a in self.work.values()]).tolist()
                if self.work else [])
        return {
            "spans": {name: {"count": st[0], "incl_ms": st[1] * 1e-6,
                             "self_ms": st[2] * 1e-6,
                             "parents": dict(self.parents[name])}
                      for name, st in self.stats.items()},
            "counters": {k: dict(c - self.base[k])
                         for k, c in counters.items()},
            "work": {name: {"sum": s, "count": a[1]}
                     for (name, a), s in zip(self.work.items(), sums)},
        }


@contextlib.contextmanager
def tracing():
    """Record the spans and device-side work counts inside the block;
    yields the :class:`Trace`."""
    global _trace
    if _trace is not None:
        raise RuntimeError("tracing is already on")
    _trace = Trace()
    try:
        yield _trace
    finally:
        _trace = None


class _GcWatch:
    """``gc.callbacks``' entry: each collection counted, timed and run
    inside a ``host.gc`` span."""

    def __init__(self):
        self.t0 = 0
        self.open = None

    def __call__(self, phase, info):
        if phase == "start":
            self.t0 = time.perf_counter_ns()
            if _trace is not None or _profiled():
                self.open = _open("host.gc")
                self.open.__enter__()
            return
        gc_counts["collections"] += 1
        gc_counts["ms"] += (time.perf_counter_ns() - self.t0) * 1e-6
        if self.open is not None:
            s, self.open = self.open, None
            s.__exit__(None, None, None)


if not any(isinstance(cb, _GcWatch) for cb in gc.callbacks):
    gc.callbacks.append(_GcWatch())


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` and :func:`tracing` around a block; writes
    ``log_dir/trace.json`` (Chrome trace format: chrome://tracing or
    Perfetto) and ``log_dir/spans.json`` (:meth:`Trace.snapshot`)."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with tracing() as tr:
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
        with open(os.path.join(log_dir, "spans.json"), "w") as fh:
            json.dump(tr.snapshot(), fh, indent=1, sort_keys=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def debug_mode(nan_checks: bool = True):
    """Per-step NaN checks in the runners inside the block (the
    reference's NaN-weight abort, as a raised ``FloatingPointError``)."""
    token = _NAN_CHECKS.set(nan_checks)
    try:
        yield
    finally:
        _NAN_CHECKS.reset(token)
