"""step_ms_p95: the 95th percentile of the time from issuing a step to
reading its expected pose back on the host, over every step of the window
(online traffic only; nothing to read in a replay)."""

import numpy as np


def read(ctx):
    ms = ctx["window"]["step_ms"]
    return float(np.percentile(ms, 95)) if ms else None
