"""runner.host_ms: host milliseconds per step inside the harness's spans
around the calls that issue a step (the runner's noise draws and its
step: ``bench.noise`` and ``bench.step``), over every traced step (every
step of the window where nothing was traced); under the profiler, so the
profiler's own cost is in it."""


def read(ctx):
    w = ctx.get("traced") or ctx["window"]
    return 1e3 * w["host_s"] / w["host_steps"] if w["host_steps"] else None
