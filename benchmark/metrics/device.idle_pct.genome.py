"""The share of the traced window in which no kernel, copy or set ran on
the card: 100 - the union of CUDA activity over the window's length."""

SOURCE = "device_trace"


def read(ctx):
    t = ctx.get("trace")
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
