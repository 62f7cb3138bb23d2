"""The bias_act kernels' 16-bit instantiations (bfloat16, float16; the
forward and the gradient, every order) at their roofline: the least time
(the bytes every 16-bit call of the traced steps reads and writes once, at
2 B an element, counted on the reference at the precision the
configuration states) over HBM bandwidth, over the device time of those
instantiations alone. The bias gradient's summing kernel, shared by every
type, and its fp32 bytes are left out of both."""

from perfbench.harness.peaks import HBM_BYTES_PER_S

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_s"
PATTERNS = ("bias_act_kernel<__half", "bias_act_kernel<__nv_bfloat16",
            "bias_act_grad_kernel<__half", "bias_act_grad_kernel<__nv_bfloat16")
OP = "bias_act"


def read(ctx):
    seconds = ctx.trace.op_seconds(PATTERNS)
    nbytes = ctx.layer.get("bytes_16bit", {}).get(OP)
    if not seconds or not nbytes:
        return None
    return 100.0 * nbytes / ctx.world / HBM_BYTES_PER_S / seconds
