"""pre.device_ms: device milliseconds per step given to the program's
``phd.pre`` range (detection planes, detect and top-T, normalisers, the
candidate tables), each device operation attributed to the first layer
range on the device timeline that ends after it starts, over the traced
steps."""

LAYER = "phd.pre"


def read(ctx):
    tl = ctx["timeline"]
    if tl is None or LAYER not in tl.layer_ns:
        return None
    return tl.layer_ns[LAYER] * 1e-6 / ctx["traced"]["steps"]
