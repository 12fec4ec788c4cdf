"""Readings from which the check's limits are set: for each seed, one
episode of a cell at its own size and load, every sampled step compared
with the reference, and the same steps computed by the control (the
reference in TF32, the precision below the configuration's float32 with
TF32 off) in the program's place. One process serves every seed, so the
set-up is paid once.

    python3 phdbench/calibrate.py --workload dense-phd.replay \\
        --seeds 1-12 [--checks 3] [--out calib.jsonl]

Prints one line per seed and, at the end, each number's largest program
reading (the lower reading) and smallest control reading (the upper).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("OMP_NUM_THREADS", "1")   # as phdbench/run.py


def seeds_of(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--checks", type=int, default=3,
                   help="sampled steps an episode")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from phdbench import harness
    cell = harness.load_cell(args.workload)
    bench = harness.Cell(cell, checks=args.checks, max_checks=args.checks)
    lower, upper = {}, {}
    fh = open(args.out, "a") if args.out else None
    for seed in seeds_of(args.seeds):
        t0 = time.perf_counter()
        bench.probe.captures = []
        win = bench.window(seed, 0.0)
        chk = bench.check(controls=True)
        row = dict(workload=args.workload, seed=seed, steps=win["steps"],
                   failed=win["failed"], checked=chk["checked"],
                   steps_per_s=win["steps"] / win["seconds"],
                   program=chk["gaps"], control=chk["control"],
                   seconds=time.perf_counter() - t0)
        print(json.dumps(row), flush=True)
        if fh:
            fh.write(json.dumps(row) + "\n")
            fh.flush()
        # a seed with no reading of a number sets neither end
        for k, v in chk["gaps"].items():
            if v is not None:
                lower[k] = max(lower.get(k, 0.0), v)
        for k, v in chk["control"].items():
            if v is not None:
                upper[k] = min(upper.get(k, math.inf), v)
    summary = dict(workload=args.workload, lower=lower, upper=upper)
    print(json.dumps(summary), flush=True)
    if fh:
        fh.write(json.dumps(summary) + "\n")
        fh.close()
    found = harness.forbidden_modules()
    if found:
        print(f"loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
