"""The whole training step's share of the card's peak: the model FLOPs of
the traced window's steps (counted on the reference at the cell's shapes
with FlopCounterMode: forward, backward and second order, no
recomputation) over the window's wall time on the host's clock, over the dense TF32 peak times
the cards used."""

from perfbench.harness.peaks import TF32_FLOP_PER_S

LAYER = "model step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_img_s"


def read(ctx):
    flops = ctx.layer.get("flops")
    if not flops:
        return None
    return 100.0 * flops / ctx.layer["window_s"] / (TF32_FLOP_PER_S * ctx.world)
