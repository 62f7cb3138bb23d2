"""Median wall time of one device batch of InferenceEngine.reconstruct,
timed around the call on the benchmark's own engine instance."""

LAYER = "engine"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "serve_p95_ms"


def read(ctx):
    return ctx.layer.get("batch_ms_median")
