"""Run one cell of the benchmark (``BENCHMARK.json``) and print its result.

    python3 phdbench/run.py --workload dense-phd.replay --seed 7 \\
        --seconds 30 --trace 0

The last line of standard output is one JSON object: ``correct``,
``attempted`` (steps run in the window), ``failed`` (steps whose outputs
were not finite), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number the reference comparison
reads, beside its limit. The same numbers end standard error.

The run exits 2 without a result where CUDA is missing or has fewer cards
than the cell asks for, and 3 where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one process with few threads: the host loop is single-threaded, and idle
# CPU-op threads only compete with it on a shared host
os.environ.setdefault("OMP_NUM_THREADS", "1")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from phdbench import harness
    # the host clock when the process began (setup_s counts from it)
    t_start = time.perf_counter() - harness.process_age_s()
    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start=t_start,
                             log=lambda msg: print(msg, flush=True))
    except harness.NoDevice as exc:
        print(f"[phdbench] {exc}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"[phdbench] loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
