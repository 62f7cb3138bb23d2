"""The upfirdn2d kernel's share of its roofline: the least time (the bytes
every FIR of the traced steps reads and writes once, forward and each
backward order, counted on the reference at the cell's shapes, over HBM
bandwidth) over the device time of the kernels named here."""

from perfbench.harness.peaks import HBM_BYTES_PER_S

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_s"
PATTERNS = ("upfirdn2d",)
OP = "upfirdn2d"


def read(ctx):
    seconds = ctx.trace.op_seconds(PATTERNS)
    nbytes = ctx.layer.get("bytes", {}).get(OP)
    if not seconds or not nbytes:
        return None
    return 100.0 * nbytes / ctx.world / HBM_BYTES_PER_S / seconds
