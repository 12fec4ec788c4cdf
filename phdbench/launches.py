"""The trace of the profiled window read by launch: each device operation
goes to the innermost program span open on the host when its launch call
was made, and each idle gap of the device is named by the program span
open when it began and by what the host was in at that moment: a CUDA
call, a garbage collection (``host.gc``), or neither (issuing).

The program's spans (``runtime/profiling.py``) are host ranges in the
trace: the layer spans (``phd.*``, ``cphd.*``, ``disp.*``), the runner's
(``runner.*``), a hand kernel's launch (``kernel.<name>``), a host sync
(``sync.<site>``) and ``host.gc``. A device operation is matched to its
launch call (a CUDA runtime or driver event) by Kineto's correlation id;
failing that, by its linked correlation to a program span (a kernel
launched inside ``kernel.<name>`` with no runtime event of its own);
failing that, it is paired in issue order with a ``kernel.*`` span that
no matched operation came from (one stream runs in issue order). What is
left is counted as unmatched. Operations launched outside every program
span are the harness's (its copies and readbacks).

The device operations are those :func:`trace.from_events` counts (device
events not named as a ``bench.*`` or ``phd.*`` host range), clipped to the
window, so the buckets here sum to the busy time its readers see.
"""

from __future__ import annotations

import collections
import re
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

from .trace import HOST_PREFIXES

PROGRAM_PREFIXES = ("phd.", "cphd.", "disp.", "runner.", "kernel.", "sync.",
                    "host.gc")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
# a host call that waits for the card or for the allocator: a synchronize,
# an allocation or release, an event wait, a synchronous copy
BLOCKING = re.compile(r"Synchroniz|Malloc|Free|HostAlloc|HostRegister"
                      r"|StreamWaitEvent|pageable|^cudaMemcpy$"
                      r"|^cuMemcpy(DtoH|HtoD|DtoD)?(_v2)?$")
CALL_NAME = re.compile(r"cu(da)?[A-Z]")
GC_SPAN = "host.gc"
OUTSIDE = "(outside the program's spans)"


class Event(NamedTuple):
    """One trace event: ``kind`` is Kineto's activity type ("kernel",
    "gpu_memcpy", "cuda_runtime", "cpu_op", "user_annotation", ...)."""
    name: str
    kind: str
    on_device: bool
    start: int
    end: int
    corr: int = 0
    linked: int = 0


def events(prof) -> List[Event]:
    """The events of a finished ``torch.profiler.profile``."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        name, on_device = e.name(), e.device_type() == cuda
        lo = e.start_ns()
        out.append(Event(name, _kind(e, name, on_device), on_device, lo,
                         lo + e.duration_ns(), e.correlation_id(),
                         e.linked_correlation_id()))
    return out


def _kind(e, name: str, on_device: bool) -> str:
    """Kineto's activity type of an event; where this torch does not give
    it, a CUDA runtime or driver call told by its name (``cudaX`` /
    ``cuX``)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if not on_device and CALL_NAME.match(name):
        return "cuda_runtime" if name.startswith("cuda") else "cuda_driver"
    return "device" if on_device else "cpu_op"


@dataclass
class Launches:
    """The window's device operations by the span that launched them."""
    window_ns: Tuple[int, int]
    total_ns: int = 0
    n_ops: int = 0
    innermost_ns: Dict[str, int] = field(default_factory=dict)
    inside_ns: Dict[str, int] = field(default_factory=dict)
    outside_ns: int = 0
    unmatched_ns: int = 0
    n_unmatched: int = 0
    matched_by: Dict[str, int] = field(default_factory=dict)
    # CUDA calls made in the window by the innermost span open around them
    # (a program span, else a harness range): span -> call -> [count, ns]
    calls: Dict[str, Dict[str, list]] = field(default_factory=dict)
    # (start, end, span, host state, the host operation open at the start)
    gaps: List[Tuple[int, int, str, str, str]] = field(default_factory=list)

    def gap_ns(self, blocked_only: bool = False) -> int:
        return sum(g[1] - g[0] for g in self.gaps
                   if not blocked_only or blocked(g[3]))

    def longest_gaps(self, n: int = 10) -> list:
        """The n longest idle gaps: [span, host state, ms, host operation]."""
        top = sorted(self.gaps, key=lambda g: g[0] - g[1])[:n]
        return [[span, host, (hi - lo) * 1e-6, op]
                for lo, hi, span, host, op in top]


def blocked(host: str) -> bool:
    """Whether a gap's host state is a blocking CUDA call or a collection."""
    return host == GC_SPAN or (host != "issuing" and bool(
        BLOCKING.search(host)))


class _Sweep:
    """The host ranges open at increasing times."""

    def __init__(self, ranges: List[Event]):
        self.ranges = sorted(ranges, key=lambda r: (r.start, -r.end))
        self.i = 0
        self.open: List[Event] = []

    def at(self, t: int) -> List[Event]:
        rs = self.ranges
        while self.i < len(rs) and rs[self.i].start <= t:
            self.open.append(rs[self.i])
            self.i += 1
        self.open = [r for r in self.open if r.end > t]
        return self.open


def _innermost(open_ranges: List[Event], prefixes) -> Optional[Event]:
    best = None
    for r in open_ranges:
        if r.name.startswith(prefixes) and (best is None
                                            or r.start >= best.start):
            best = r
    return best


def read(evs: List[Event], window_name: str = "bench.window") -> Launches:
    """The launch-read trace of the events between the ``window_name``
    range's start and end (the program issues from one host thread)."""
    win = [e for e in evs if not e.on_device and e.name == window_name]
    if not win:
        raise RuntimeError(f"the trace holds no {window_name} range")
    w_lo, w_hi = win[0].start, win[0].end
    host = [e for e in evs if not e.on_device]
    range_names = {e.name for e in host if e.name.startswith(HOST_PREFIXES)}
    spans = [e for e in host if e.kind not in LAUNCH_KINDS
             and e.name.startswith(PROGRAM_PREFIXES)]
    calls = [e for e in host if e.kind in LAUNCH_KINDS]
    call_by_corr = {e.corr: e for e in calls}
    span_by_corr = {e.corr: e for e in spans if e.corr}
    ops = sorted((e for e in evs if e.on_device
                  and e.name not in range_names
                  and e.end > w_lo and e.start < w_hi),
                 key=lambda e: e.start)
    out = Launches(window_ns=(w_lo, w_hi), n_ops=len(ops))

    # each operation's launch time on the host: its runtime or driver
    # call's start, else the start of the program span it is linked to
    launched: Dict[int, int] = {}
    how = collections.Counter()
    for i, op in enumerate(ops):
        call = call_by_corr.get(op.corr)
        if call is not None:
            launched[i] = call.start
            how["call"] += 1
        elif op.linked in span_by_corr:
            launched[i] = span_by_corr[op.linked].start
            how["linked span"] += 1
    # the rest, in issue order, to the kernel.* spans no operation came from
    kernel_spans = [s for s in spans if s.name.startswith("kernel.")]
    sweep, used = _Sweep(kernel_spans), set()
    for t in sorted(launched.values()):
        s = _innermost(sweep.at(t), ("kernel.",))
        if s is not None:
            used.add(s)
    free = iter(sorted((s for s in kernel_spans if s not in used),
                       key=lambda s: s.start))
    nxt = next(free, None)
    for i, op in enumerate(ops):
        if i not in launched and nxt is not None and nxt.start <= op.start:
            launched[i] = nxt.start
            how["kernel span in order"] += 1
            nxt = next(free, None)
    out.matched_by = dict(how)

    # each launch to the innermost program span open then
    inner, inside = collections.Counter(), collections.Counter()
    sweep = _Sweep(spans)
    for i in sorted(launched, key=launched.get):
        op = ops[i]
        ns = min(op.end, w_hi) - max(op.start, w_lo)
        open_now = [r for r in sweep.at(launched[i])
                    if r.name.startswith(PROGRAM_PREFIXES)]
        s = _innermost(open_now, PROGRAM_PREFIXES)
        if s is None:
            out.outside_ns += ns
            continue
        inner[s.name] += ns
        for name in {r.name for r in open_now}:
            inside[name] += ns
    for i, op in enumerate(ops):
        ns = min(op.end, w_hi) - max(op.start, w_lo)
        out.total_ns += ns
        if i not in launched:
            out.unmatched_ns += ns
            out.n_unmatched += 1
    out.innermost_ns, out.inside_ns = dict(inner), dict(inside)

    # each CUDA call by the span it was made in
    sweep = _Sweep(spans + [e for e in host if e.name.startswith("bench.")
                            and e.name != window_name])
    for c in sorted(calls, key=lambda c: c.start):
        if not w_lo <= c.start < w_hi:
            continue
        open_now = sweep.at(c.start)
        s = (_innermost(open_now, PROGRAM_PREFIXES)
             or _innermost(open_now, ("bench.",)))
        acc = out.calls.setdefault(s.name if s else OUTSIDE, {}).setdefault(
            c.name, [0, 0])
        acc[0] += 1
        acc[1] += c.end - c.start

    # each idle gap by the span, the host call and the innermost other host
    # operation (a PyTorch op, say) open when it began
    pageable = {e.corr for e in ops if "Pageable" in e.name}
    sweep = _Sweep([e for e in host if e.name != window_name])
    for lo, hi in _gaps(ops, w_lo, w_hi):
        open_now = sweep.at(lo)
        other = _innermost([r for r in open_now if r.kind not in LAUNCH_KINDS
                            and not r.name.startswith(PROGRAM_PREFIXES
                                                      + HOST_PREFIXES)],
                           ("",))
        named = [r for r in open_now if r.name != GC_SPAN]
        s = (_innermost(named, PROGRAM_PREFIXES)
             or _innermost(named, ("bench.",)))
        call = _innermost([r for r in open_now if r.kind in LAUNCH_KINDS],
                          ("",))
        if call is not None:
            state = call.name + (" (pageable)" if call.corr in pageable
                                 else "")
        elif any(r.name == GC_SPAN for r in open_now):
            state = GC_SPAN
        else:
            state = "issuing"
        out.gaps.append((lo, hi, s.name if s else OUTSIDE, state,
                         other.name if other else ""))
    return out


def _gaps(ops: List[Event], lo: int, hi: int) -> List[Tuple[int, int]]:
    """Idle intervals of the device inside [lo, hi) (``Timeline.gaps``'s
    rule)."""
    out, t = [], lo
    for op in ops:
        if op.start > t:
            out.append((t, op.start))
        t = max(t, op.end)
    if hi > t:
        out.append((t, hi))
    return out
