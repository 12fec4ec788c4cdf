"""merge.device_ms: device milliseconds per step given to the program's
``phd.merge`` range (the greedy merge of the selected candidates),
each device operation attributed to the first layer
range on the device timeline that ends after it starts, over the traced
steps."""

LAYER = "phd.merge"


def read(ctx):
    tl = ctx["timeline"]
    if tl is None or LAYER not in tl.layer_ns:
        return None
    return tl.layer_ns[LAYER] * 1e-6 / ctx["traced"]["steps"]
