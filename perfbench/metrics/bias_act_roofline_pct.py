"""The bias_act kernels' share of their roofline (forward, gradient and
second order): the least time (the bytes every call of the traced steps
reads and writes once, counted on the reference at the cell's shapes, over
HBM bandwidth) over the device time of the kernels named here."""

from perfbench.harness.peaks import HBM_BYTES_PER_S

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_s"
PATTERNS = ("bias_act",)
OP = "bias_act"


def read(ctx):
    seconds = ctx.trace.op_seconds(PATTERNS)
    nbytes = ctx.layer.get("bytes", {}).get(OP)
    if not seconds or not nbytes:
        return None
    return 100.0 * nbytes / ctx.world / HBM_BYTES_PER_S / seconds
