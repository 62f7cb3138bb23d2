"""NCCL kernels' device time over the traced window on rank 0's card: the
data-parallel gradient all-reduce and the batch collectives."""

LAYER = "data parallelism"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_s"
PATTERNS = ("nccl", "Nccl")


def read(ctx):
    tr = ctx.trace
    seconds = None if tr is None else tr.op_seconds(PATTERNS)
    if not seconds:
        return None
    return 100.0 * seconds / tr.window_s
