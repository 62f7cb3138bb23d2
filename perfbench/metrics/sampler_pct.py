"""Share of the traced window in VisCoIN's K-step presampling of synthetic
batches (the benchmark's span around the sampler call, synchronised at both
ends in a traced run)."""

LAYER = "VisCoIN step"
UNIT = "%"
SOURCE = "program_span"
MOVES = "train_img_s"


def read(ctx):
    s = ctx.layer.get("span_s", {}).get("sampler")
    if s is None:
        return None
    return 100.0 * s / ctx.layer["window_s"]
