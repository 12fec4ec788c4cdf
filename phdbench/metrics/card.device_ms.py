"""card.device_ms: device milliseconds per step given to the CPHD step's
``cphd.card`` range (the ESF scans, the Psi terms and their inner
products, the updated cardinality), each device operation attributed to
the first layer range on the device timeline that ends after it starts,
over the traced steps."""

LAYER = "cphd.card"


def read(ctx):
    tl = ctx["timeline"]
    if tl is None or LAYER not in tl.layer_ns:
        return None
    return tl.layer_ns[LAYER] * 1e-6 / ctx["traced"]["steps"]
