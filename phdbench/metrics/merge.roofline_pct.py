"""merge.roofline_pct: the greedy 2D merge's bound over the measured device
time of every launch in the traced window whose kernel name matches
PATTERNS. The bound (``roofline.merge_bound_s``: its activity plane read
and its output planes written; the entering lanes are not seen in a run)
counts each traced step that updates the map once."""

import re

from phdbench.roofline import merge_bound_s

PATTERNS = re.compile(r"\bmerge2d(_tables)?_kernel\b|\btables_wide_kernel\b"
                      r"|\bwide_kernel<\s*(Gauss2|Hell2)\b")


def read(ctx):
    tl = ctx["timeline"]
    if tl is None:
        return None
    times = [hi - lo for name, lo, hi in tl.ops if PATTERNS.search(name)]
    if not times or sum(times) <= 0:
        return None
    s = ctx["shapes"]
    bound = len(ctx["traced"]["z_counts"]) * merge_bound_s(
        s["P"], s["cap"], s["K"])
    return 100.0 * bound / (sum(times) * 1e-9)
