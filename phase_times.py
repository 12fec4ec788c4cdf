"""Wall time of each phase of ``chip_smoke.py``: this checkout's, or an
older one's to set beside it.

    python3 phase_times.py --root runs/parent

runs the ``chip_smoke.py`` of the checkout at ``--root`` (default: this
one) from that directory with its own package, each module-level function
that its ``main`` calls by name timed (outermost calls only, so a phase
that calls another is counted once), and prints its output and then one
``[phases] {...}`` line: seconds per phase in the order they ended.
``chip_smoke.py`` times itself the same way (:func:`time_phases`) and
prints the same line before its report, so two checkouts compare phase by
phase; put both in one chip call.
"""

from __future__ import annotations

import argparse
import ast
import inspect
import json
import os
import sys
import textwrap
import time


def time_phases(module, seconds: dict) -> None:
    """Wrap each function of ``module`` that ``module.main`` calls by name
    so that its wall time adds up in ``seconds[name]``; a call made while
    another wrapped call runs is not counted again."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(module.main)))
    names = dict.fromkeys(
        node.func.id for node in ast.walk(tree)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name))
    depth = [0]

    def timed(name, fn):
        def call(*args, **kwargs):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    seconds[name] = (seconds.get(name, 0.0)
                                     + time.perf_counter() - t0)
        return call

    for name in names:
        fn = getattr(module, name, None)
        if inspect.isfunction(fn) and fn.__module__ == module.__name__:
            setattr(module, name, timed(name, fn))


def phases_line(seconds: dict) -> str:
    """The ``[phases]`` line: seconds per phase, rounded to 0.01 s."""
    return "[phases] " + json.dumps({k: round(v, 2)
                                     for k, v in seconds.items()})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)), help="checkout whose chip_smoke.py runs")
    root = os.path.abspath(ap.parse_args().root)
    here = os.path.dirname(os.path.abspath(__file__))
    # the checkout's own modules, not this one's
    sys.path[:] = [root] + [p for p in sys.path
                            if os.path.abspath(p or ".") != here]
    os.chdir(root)
    import chip_smoke
    seconds: dict = {}
    time_phases(chip_smoke, seconds)
    try:
        rc = chip_smoke.main()
    finally:
        print(phases_line(seconds), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
