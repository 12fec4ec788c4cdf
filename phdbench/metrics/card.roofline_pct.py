"""card.roofline_pct: the CPHD cardinality prediction's bound over the
measured device time of every launch in the traced window whose kernel
name matches PATTERN. The bound (``roofline.cardinality_bound_s`` at the
configuration's C+1 = max_cardinality + 1 values) counts each traced step
that updates the map once: the step launches the prediction once."""

import re

from phdbench.roofline import cardinality_bound_s

PATTERN = re.compile(r"\bcardinality_predict_kernel\b")


def read(ctx):
    tl = ctx["timeline"]
    if tl is None or "max_cardinality" not in ctx.get("config", {}):
        return None
    times = [hi - lo for name, lo, hi in tl.ops if PATTERN.search(name)]
    if not times or sum(times) <= 0:
        return None
    bound = len(ctx["traced"]["z_counts"]) * cardinality_bound_s(
        ctx["shapes"]["P"], int(ctx["config"]["max_cardinality"]) + 1)
    return 100.0 * bound / (sum(times) * 1e-9)
