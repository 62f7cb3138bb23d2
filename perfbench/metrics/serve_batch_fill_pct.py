"""The micro-batcher's mean batch occupancy (BatcherStats of the
reconstruct endpoint) over the engine's device batch."""

LAYER = "micro-batcher"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "serve_p95_ms"


def read(ctx):
    return ctx.layer.get("batch_fill_pct")
