"""runner.step_ms_p95.host_paced: in the Ackerman online cell, the 95th
percentile of the time from issuing a step to reading its expected pose
back on the host, over the window's steps that ran outside the profiler
(the traced run profiles its first episodes; their steps are left out).

The host's issue sets these steps' times, and the tail of one run reads
~18% from another's (more than any end-to-end bound may allow), so the
tail is read here, beside the cell's ``steps_per_s.host_paced``, and
holds no bound."""

import numpy as np


def read(ctx):
    ms = ctx["window"]["step_ms"]
    traced = ctx.get("traced")
    if traced:
        ms = ms[traced["steps"]:]
    return float(np.percentile(ms, 95)) if len(ms) else None
