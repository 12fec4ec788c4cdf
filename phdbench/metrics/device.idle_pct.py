"""device.idle_pct: the share of the traced window in which no kernel,
copy or memset ran on the card (the union of the device intervals)."""


def read(ctx):
    tl = ctx["timeline"]
    if tl is None or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_ns() * 1e-9 / tl.window_s)
