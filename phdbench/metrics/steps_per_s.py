"""steps_per_s: every step of every episode in the window over the window's
host-clock length (it ends in a device synchronize)."""


def read(ctx):
    w = ctx["window"]
    return w["steps"] / w["seconds"] if w["seconds"] > 0 else None
