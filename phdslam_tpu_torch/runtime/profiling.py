"""Timing, tracing and the NaN checks (port of
``phdslam_tpu/runtime/profiling.py``).

* per-step wall clock -> ``loopTime.log``: written by the runners;
  :class:`StepTimer` is the shared accumulator.
* the prediction's own time -> ``predicttime.log``: :func:`timed_call`
  waits for the card before it reads the clock.
* :func:`trace`: ``torch.profiler`` (CPU and, with a card, CUDA activity)
  around a block, exported as a Chrome trace into a directory.
* :func:`debug_mode`: the runners check every step for NaN weights and
  raise ``FloatingPointError`` at the first (without it they report the
  first NaN step after the run and return). It does not switch on
  ``torch.autograd.detect_anomaly``: that guards backward passes, and the
  filter has none.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import time
from typing import List, Optional

import torch

_NAN_CHECKS = contextvars.ContextVar("nan_checks", default=False)


def nan_checks() -> bool:
    """True inside :func:`debug_mode`."""
    return _NAN_CHECKS.get()


def synchronize() -> None:
    """Wait for the card's queued work (nothing to wait for when the
    process never touched a card)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Wall-clock accumulator in the loopTime.log format."""

    def __init__(self):
        self.times_ms: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_on=None):
        """Record the time since :meth:`start`, first waiting for the
        card when ``sync_on`` (the step's outputs) is given."""
        if sync_on is not None:
            synchronize()
        self.times_ms.append((time.perf_counter() - self._t0) * 1000.0)

    def write(self, path: str):
        with open(path, "w") as fh:
            fh.write("\n".join("%g" % t for t in self.times_ms) + "\n")


def timed_call(fn, *args, **kwargs):
    """Run fn, wait for its outputs on the card, return (result,
    elapsed_ms): the predicttime.log pattern."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    synchronize()
    return out, (time.perf_counter() - t0) * 1000.0


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` around a block; writes ``log_dir/trace.json``
    (Chrome trace format: chrome://tracing or Perfetto)."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
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
