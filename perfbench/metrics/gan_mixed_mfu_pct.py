"""The whole mixed-precision training step's share of the card's peak: the
model FLOPs of the traced window's steps at each precision (counted on the
reference at the precision the configuration states for each block:
forward, backward and second order) over that precision's dense peak,
summed as the least time the card could take, over the window's wall time
on the host's clock, times the cards used."""

from perfbench.harness.peaks import TF32_FLOP_PER_S

LAYER = "model step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_img_s"
# Dense FP16 / BF16 tensor-core peak of one H100 SXM (NVIDIA's data sheet,
# without sparsity).
HALF_FLOP_PER_S = 989.4e12


def read(ctx):
    flops = ctx.layer.get("flops_by_precision")
    if not flops or not sum(flops.values()):
        return None
    least_s = flops["16bit"] / HALF_FLOP_PER_S + flops["fp32"] / TF32_FLOP_PER_S
    return 100.0 * least_s / ctx.layer["window_s"] / ctx.world
