"""detect.roofline_pct: the fused detection + top-T's bound over the
measured device time of every launch in the traced window whose kernel
name matches PATTERNS. The bound is the work the traced steps' inputs
need (``roofline.detect_bound_s``): each step that updates the map counted
once, at its valid measurements (not the scan's padded rows) and at the
map's capacity K (its live components are not read in a run)."""

import re

from phdbench.roofline import detect_bound_s

PATTERNS = re.compile(r"\bdetect(_cons)?(_wide)?_kernel\b")


def read(ctx):
    tl = ctx["timeline"]
    if tl is None:
        return None
    times = [hi - lo for name, lo, hi in tl.ops if PATTERNS.search(name)]
    if not times or sum(times) <= 0:
        return None
    s = ctx["shapes"]
    bound = sum(detect_bound_s(s["P"], m, s["K"], s["T"])
                for m in ctx["traced"]["z_counts"])
    return 100.0 * bound / (sum(times) * 1e-9)
