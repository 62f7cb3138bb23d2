"""Share of the traced window in the GAN's regularised steps (lazy R1 and
path length), timed by the benchmark's spans around those steps,
synchronised at both ends in a traced run."""

LAYER = "GAN trainer"
UNIT = "%"
SOURCE = "program_span"
MOVES = "train_img_s"


def read(ctx):
    s = ctx.layer.get("span_s", {}).get("reg_step")
    if s is None:
        return None
    return 100.0 * s / ctx.layer["window_s"]
