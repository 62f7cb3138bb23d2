"""The upfirdn2d kernel's 16-bit instantiations (bfloat16, float16) at
their roofline: the least time (the bytes every 16-bit FIR of the traced
steps reads and writes once, at 2 B an element, forward and each backward
order, counted on the reference at the precision the configuration states)
over HBM bandwidth, over the device time of those instantiations alone."""

from perfbench.harness.peaks import HBM_BYTES_PER_S

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_s"
PATTERNS = ("upfirdn2d_tiled<__half", "upfirdn2d_tiled<__nv_bfloat16")
OP = "upfirdn2d"


def read(ctx):
    seconds = ctx.trace.op_seconds(PATTERNS)
    nbytes = ctx.layer.get("bytes_16bit", {}).get(OP)
    if not seconds or not nbytes:
        return None
    return 100.0 * nbytes / ctx.world / HBM_BYTES_PER_S / seconds
