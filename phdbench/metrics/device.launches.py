"""device.launches: device operations (kernels, copies, memsets) in the
traced window per step."""


def read(ctx):
    tl = ctx["timeline"]
    if tl is None or not ctx["traced"]["steps"]:
        return None
    return len(tl.ops) / ctx["traced"]["steps"]
