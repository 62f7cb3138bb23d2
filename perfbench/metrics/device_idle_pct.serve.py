"""Share of the traced window in which no operation ran on the card (the
union of the device operations' intervals, so overlapping kernels count
once)."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "serve_p95_ms"


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
