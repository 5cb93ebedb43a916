"""Share of the traced window in which nothing ran on the card: no kernel,
copy or fill (the union of their intervals in the profiler's CUDA trace)."""
UNIT = "%"
LAYER = "device"


def read(ctx):
    dev = ctx.device
    if dev is None or dev.window_s <= 0 or dev.busy_s <= 0:
        return None
    return 100.0 * (1.0 - dev.busy_s / dev.window_s)
