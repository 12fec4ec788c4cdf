"""Times the port's two gather kernels at every shape the paths launch.

    python3 gather_bench.py [--root DIR] [--label NAME]

Needs one NVIDIA GPU; imports no jax. ``phdslam_tpu_torch`` is imported
from DIR (default: the directory of this script), so that two checkouts can
be held side by side on one card in one call: unpack the other into a
directory that ``.gitignore`` lists and run parent, change, change, parent.

This module is also the one home of the gathers' cases: ``GATHER_CASES``
(every shape the paths launch, and the ragged, unaligned, out-of-range and
above-budget edges), ``gather_case``, which makes them, and the timing
helpers.
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` import them.

For each case of ``GATHER_TIMED`` it checks the kernel against its twin bit
for bit and prints one JSON line: the kernel's time per eager call
(``call_ms``, host included: what a caller of the wrapper waits), its
device time (``graph_ms``), the same two for ``torch.gather`` on the same
inputs, and the byte bound (``bound_ms``). Each timed call reads a fresh
input set in turn, enough of them to exceed twice the 50 MB L2, so that
the inputs come from device memory as the bound assumes.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys

import torch

HBM_BPS = 3.35e12               # H100 SXM data sheet, bytes/s at 700 W
L2_BYTES = 50 * 2 ** 20         # H100 L2

# name: (kernel, P, C, R, cap, options). The column gather reads
# tab [P, C, R] at idx [P, cap]; the row gather tab [P, R, C]. Indices are
# drawn with repeats from [0, R), or from [lo, hi) where the options give
# them (outside [0, R) gives 0); "distinct": each particle's indices are a
# prefix of a permutation of [0, R) (the post-merge compaction's sort
# order); "offset": the table starts that many floats into its storage on
# the device (unaligned for the bulk copy).
GATHER_CASES = {
    # the shapes the paths launch. t_k and t_m: the candidate tables
    # (feature and measurement columns) at the top-cap selection's lanes;
    # post: the post-merge compaction. Ackerman (PHD and CPHD, P=512),
    # dense (P=1024), the mixed dynamic 4D map; slabs above the budget
    "t_k": ("cols", 512, 16, 128, 512, {}),
    "t_m": ("cols", 512, 8, 48, 512, {}),
    "post": ("cols", 512, 5, 256, 128, {"distinct": True}),
    "dense t_k": ("cols", 1024, 16, 1024, 1536, {}),
    "dense t_m": ("cols", 1024, 8, 72, 1536, {}),
    "dense post": ("cols", 1024, 5, 2048, 1024, {"distinct": True}),
    "mixed 4D t_k": ("cols", 512, 46, 128, 128, {}),
    "mixed 4D t_m": ("cols", 512, 22, 32, 128, {}),
    "mixed 4D post": ("cols", 512, 14, 256, 128, {"distinct": True}),
    "above budget": ("cols", 512, 16, 8192, 512, {}),
    "rows": ("rows", 512, 16, 128, 512, {}),
    "rows dense": ("rows", 1024, 16, 1024, 1536, {}),
    "rows above budget": ("rows", 512, 16, 8192, 512, {}),
    # the other shapes the paths launch: the consolidating t_k, CPHD's t_m,
    # mixed's static t_m, the mixed accuracy runs' K=24 maps
    "consolidating t_k": ("cols", 512, 21, 128, 512, {}),
    "CPHD t_m": ("cols", 512, 2, 48, 512, {}),
    "mixed static t_m": ("cols", 512, 8, 32, 512, {}),
    "mixed K=24 t_k": ("cols", 256, 16, 24, 512, {}),
    "mixed K=24 4D t_k": ("cols", 256, 46, 24, 512, {}),
    "mixed K=24 4D t_m": ("cols", 256, 22, 32, 512, {}),
    "mixed K=24 post": ("cols", 256, 5, 48, 24, {"distinct": True}),
    "mixed K=24 4D post": ("cols", 256, 14, 48, 24, {"distinct": True}),
    # edges: C R % 4 != 0, cap % 4 != 0, cap 1, one particle, every index
    # out of range, an unaligned table, a ragged slab above the budget
    "cr ragged": ("cols", 64, 5, 47, 512, {"lo": -2, "hi": 49}),
    "cap ragged": ("cols", 64, 5, 47, 509, {"lo": -2, "hi": 49}),
    "cap 1": ("cols", 3, 16, 128, 1, {"lo": -2, "hi": 130}),
    "p 1": ("cols", 1, 16, 128, 512, {"lo": -2, "hi": 130}),
    "out of range above": ("cols", 64, 16, 128, 512, {"lo": 128, "hi": 300}),
    "out of range below": ("cols", 64, 5, 47, 509, {"lo": -50, "hi": 0}),
    "unaligned table": ("cols", 64, 5, 47, 509,
                        {"lo": -2, "hi": 49, "offset": 1}),
    "unaligned table 2": ("cols", 64, 16, 128, 512,
                          {"lo": -2, "hi": 130, "offset": 2}),
    "above budget ragged": ("cols", 7, 5, 8191, 509,
                            {"lo": -2, "hi": 8193}),
    "rows ragged p": ("rows", 513, 16, 128, 512, {"lo": -2, "hi": 130}),
    "rows c ragged": ("rows", 64, 5, 47, 509, {"lo": -2, "hi": 49}),
    "rows cap 1": ("rows", 1, 16, 128, 1, {"lo": -2, "hi": 130}),
    "rows wide row": ("rows", 64, 300, 40, 64, {"lo": -2, "hi": 42}),
    "rows out of range": ("rows", 64, 16, 128, 512, {"lo": -9, "hi": -1}),
    "rows unaligned table": ("rows", 64, 16, 128, 512,
                             {"lo": -2, "hi": 130, "offset": 1}),
    "rows above budget ragged": ("rows", 7, 5, 8191, 509,
                                 {"lo": -2, "hi": 8193}),
}
# the cases timed: the shapes the paths launch at the Ackerman, dense and
# mixed 4D sizes, and one slab above the budget for each gather
GATHER_TIMED = ("t_k", "t_m", "post", "dense t_k", "dense t_m",
                "dense post", "mixed 4D t_k", "mixed 4D t_m",
                "mixed 4D post", "above budget", "rows", "rows dense",
                "rows above budget")


def gather_case(dev, name, seed=0):
    """(idx int32 [P, cap], tab) of GATHER_CASES[name] on ``dev``."""
    kind, P, C, R, cap, opt = GATHER_CASES[name]
    g = torch.Generator().manual_seed(P + C + R + cap + 1000 * seed)
    if opt.get("distinct"):
        idx = torch.argsort(torch.rand((P, R), generator=g), dim=1)[:, :cap]
    else:
        idx = torch.randint(opt.get("lo", 0), opt.get("hi", R), (P, cap),
                            generator=g)
    off = opt.get("offset", 0)
    # the offset is taken on the device, so the table's address there is
    # off floats past an aligned allocation
    store = (torch.randn(P * C * R + off, generator=g) * 10.0).to(dev)
    tab = store[off:].view((P, C, R) if kind == "cols" else (P, R, C))
    return idx.to(torch.int32).to(dev), tab


def torch_gather_index(kind, idx, tab):
    """torch.gather's int64 index for the same gather (every index must be
    in range), and its axis."""
    if kind == "cols":
        return 2, idx.long()[:, None, :].expand(-1, tab.shape[1], -1)
    return 1, idx.long()[:, :, None].expand(-1, -1, tab.shape[2])


def gather_sets(dev, name):
    """Input sets of GATHER_CASES[name], each (idx, tab, torch.gather's
    axis and index): enough that cycling through them reads more than twice
    the L2, at most 50."""
    kind, P, C, R, cap, _ = GATHER_CASES[name]
    n_in = 4 * P * (C * R + cap)
    n = max(1, min(50, -(-2 * L2_BYTES // n_in)))
    sets = []
    for seed in range(n):
        idx, tab = gather_case(dev, name, seed)
        sets.append((idx, tab, *torch_gather_index(kind, idx, tab)))
    return sets


def cycling(fn, sets):
    """A call of ``fn`` on the next of ``sets`` each time."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def gather_bound(idx, C, R):
    """The least time (ms) a gather could take on these inputs: idx read
    once, the table entries its in-range indices select read once (C
    floats per distinct index), the output written once, over HBM
    bandwidth."""
    s = torch.sort(idx, dim=1).values
    ok = (s >= 0) & (s < R)
    first = torch.ones_like(ok)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    distinct = int((ok & first).sum())
    n_bytes = 4 * (idx.numel() + C * distinct + C * idx.numel())
    return n_bytes / HBM_BPS * 1e3


def time_call(fn, iters=50, warmup=5):
    """ms per eager call: CUDA events around ``iters`` calls after
    ``warmup``. A call shorter than its host work reads the host: this is
    what a caller of the wrapper waits."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=50):
    """Device ms per call: ``iters`` calls captured in one CUDA graph and
    replayed, CUDA events around each replay, the smaller of two replays
    after a warm-up one. No host work between the launches; each call's
    output is kept, so no two calls write the same memory."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    outs = []
    with torch.cuda.graph(graph):
        for _ in range(iters):
            outs.append(fn())
    graph.replay()
    best = float("inf")
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def card_name():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def bench_parser(doc):
    """The side-by-side options of a bench script: --root DIR, the
    checkout whose phdslam_tpu_torch is timed, and --label NAME."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="checkout whose phdslam_tpu_torch is timed")
    ap.add_argument("--label", default="", help="tag on every line")
    return ap


def open_checkout(prog, root):
    """Imports phdslam_tpu_torch from ``root`` (exits if it comes from
    elsewhere, or if there is no CUDA device) and builds its kernels.
    Returns the card's name and power limit."""
    if not torch.cuda.is_available():
        sys.exit(f"{prog}: no CUDA device")
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from phdslam_tpu_torch.kernels import build
    if not build.__file__.startswith(root):
        sys.exit(f"{prog}: imported {build.__file__}, not {root}")
    build.library()
    return card_name()


def main():
    args = bench_parser(__doc__).parse_args()
    card = open_checkout("gather_bench.py", args.root)
    from phdslam_tpu_torch.kernels import build
    from phdslam_tpu_torch.kernels.gather_cols import (gather_cols,
                                                       gather_cols_reference)
    from phdslam_tpu_torch.kernels.gather_rows import (gather_rows,
                                                       gather_rows_reference)
    dev = torch.device("cuda:0")
    kernels = {"cols": (gather_cols, gather_cols_reference),
               "rows": (gather_rows, gather_rows_reference)}
    for name in GATHER_TIMED:
        kind, P, C, R, cap, _ = GATHER_CASES[name]
        kern, twin = kernels[kind]
        sets = gather_sets(dev, name)
        build.reset_launch_counts()
        for idx, tab, _, _ in sets:
            if not torch.equal(kern(idx, tab), twin(idx, tab)):
                sys.exit(f"gather_bench.py: {name} differs from its twin")
        launched = sorted(build.launch_counts)
        k = cycling(lambda i, t, a, x: kern(i, t), sets)
        lib = cycling(lambda i, t, a, x: torch.gather(t, a, x), sets)
        # eager calls in turns, kernel and torch.gather: the host's share
        # drifts with the shared host's load
        calls = [time_call(fn) for fn in (k, lib, k, lib)]
        print(json.dumps({
            "label": args.label, "shape": name, "kernel": kind, "P": P,
            "C": C, "R": R, "cap": cap, "input_sets": len(sets),
            "launched": launched,
            "call_ms": min(calls[0::2]), "graph_ms": graph_ms(k),
            "torch_gather_call_ms": min(calls[1::2]),
            "torch_gather_graph_ms": graph_ms(lib),
            "bound_ms": sum(gather_bound(s[0], C, R) for s in sets)
            / len(sets), "card": card}), flush=True)


if __name__ == "__main__":
    main()
