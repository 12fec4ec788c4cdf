"""Reduction of a ``torch.profiler`` trace of the measured window to what
the per-layer readers need: the device operations (kernels, copies and
memsets) inside the window, their union (busy time), their layer by the
program's layer ranges (``phd.*``, and each filter's own: ``cphd.*``,
``disp.*``), and the idle gaps named by the host range that was open when
each began.

A kernel launched through ctypes carries no correlation to a host range,
so it can sit in the gap before its range's first PyTorch kernel: every
device operation goes to the first layer range on the device timeline
that ends after it starts (its own range, or the next one when it sits in
a gap). This rule is the one the port's own profile script uses.
"""

from __future__ import annotations

import bisect
import collections
from dataclasses import dataclass, field
from typing import List, Tuple

LAYER_PREFIXES = ("phd.", "cphd.", "disp.")
HOST_PREFIXES = ("bench.",) + LAYER_PREFIXES
NAME_CHARS = 160        # a kernel's name in the breakdown, cut to this


@dataclass
class Timeline:
    window_ns: Tuple[int, int]
    ops: List[Tuple[str, int, int]]              # (name, start, end)
    layer_ns: dict = field(default_factory=dict)  # layer range -> device ns
    host_ranges: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) * 1e-9

    def busy_ns(self) -> int:
        """Nanoseconds of the window in which some device operation ran."""
        total, cur_lo, cur_hi = 0, None, None
        for _, lo, hi in sorted(self.ops, key=lambda o: o[1]):
            if cur_hi is None or lo > cur_hi:
                if cur_hi is not None:
                    total += cur_hi - cur_lo
                cur_lo, cur_hi = lo, hi
            else:
                cur_hi = max(cur_hi, hi)
        if cur_hi is not None:
            total += cur_hi - cur_lo
        return total

    def gaps(self) -> List[Tuple[int, int]]:
        """Idle intervals of the device inside the window."""
        out, t = [], self.window_ns[0]
        for _, lo, hi in sorted(self.ops, key=lambda o: o[1]):
            if lo > t:
                out.append((t, lo))
            t = max(t, hi)
        if self.window_ns[1] > t:
            out.append((t, self.window_ns[1]))
        return out

    def host_range_at(self, t: int) -> str:
        """The innermost harness or program range open on the host at t."""
        best = None
        for name, lo, hi in self.host_ranges:
            if lo <= t < hi and (best is None or lo >= best[1]):
                best = (name, lo)
        return best[0] if best else "outside the ranges"

    def op_seconds(self) -> dict:
        by = collections.defaultdict(float)
        for name, lo, hi in self.ops:
            by[name] += (hi - lo) * 1e-9
        return by

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps, each named by the host range open when it began."""
        ops = sorted(self.op_seconds().items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[name[:NAME_CHARS], s] for name, s in ops],
                "idle_gaps": [[self.host_range_at(lo), (hi - lo) * 1e-9]
                              for lo, hi in gaps]}


def timeline(prof, window_name: str = "bench.window") -> Timeline:
    """The window's timeline from a finished ``torch.profiler.profile``."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return from_events(
        ((e.name(), e.device_type() == cuda, e.start_ns(),
          e.start_ns() + e.duration_ns())
         for e in prof.profiler.kineto_results.events()), window_name)


def from_events(events, window_name: str = "bench.window") -> Timeline:
    """The window's timeline from (name, on_device, start_ns, end_ns)
    events: host ranges, and device operations and ranges."""
    host, dev = [], []
    for name, on_device, lo, hi in events:
        if on_device:
            dev.append((name, lo, hi))
        elif name.startswith(HOST_PREFIXES):
            host.append((name, lo, hi))
    win = [(lo, hi) for name, lo, hi in host if name == window_name]
    if not win:
        raise RuntimeError(f"the trace holds no {window_name} range")
    w_lo, w_hi = win[0]
    range_names = {name for name, _, _ in host}
    spans = sorted(((n, lo, hi) for n, lo, hi in dev if n in range_names),
                   key=lambda s: s[1])
    ops = [(n, max(lo, w_lo), min(hi, w_hi)) for n, lo, hi in dev
           if n not in range_names and hi > w_lo and lo < w_hi]
    layers = [s for s in spans if s[0].startswith(LAYER_PREFIXES)]
    ends = [s[2] for s in layers]
    per_layer = collections.defaultdict(int)
    for name, lo, hi in ops:
        i = bisect.bisect_right(ends, lo)
        per_layer[layers[i][0] if i < len(layers) else "(after the ranges)"] \
            += hi - lo
    return Timeline(window_ns=(w_lo, w_hi), ops=ops, layer_ns=dict(per_layer),
                    host_ranges=[h for h in host if h[0] != window_name])
