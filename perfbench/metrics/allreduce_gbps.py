"""The data-parallel collectives' rate on rank 0's card: the bytes the
program counts in its gradient all-reduce and its global means (the "grad"
and "mean" kinds of ``parallel/mesh.py::collective_counts``, each
collective's buffer once) over the NCCL kernels' device time in the traced
window.

The program's counters run from the process's start, over the set-up's
steps and the window's, while the trace covers the window alone: the
window's bytes are the run's bytes per step (every step all-reduces G's and
D's whole gradients) times the window's steps. The NCCL time also holds the
minibatch-stddev gathers, which these kinds do not count. Where the program
counts neither kind, nothing is read.

So this is no link bandwidth. The NCCL time on rank 0 holds every NCCL
kernel of the window: the gradient all-reduce, the global means, the
uncounted data-parallel batch gathers (``all_gather_batch``, an all-reduce,
in the discriminator's minibatch-stddev), the window's stop-flag all-reduce,
and each kernel's wait for the slowest rank. The reading moves with the
ranks' skew and with the other collectives as much as with the links.
The counters run per process and nothing here resets them, so the scaling
to the window holds for one run per process, as the benchmark's runs are
(``runner.run_ranks_many`` runs several, untraced, where no reader runs).
``perfbench/phases.py`` reads the kernels launched inside the
``dp.allreduce_grads`` span and the window's own counts instead."""

LAYER = "data parallelism"
UNIT = "GB/s"
SOURCE = "program_counter"
MOVES = "train_img_s"
PATTERNS = ("nccl", "Nccl")
KINDS = ("grad_bytes", "mean_bytes")


def read(ctx):
    from viscoin_tpu_torch.parallel.mesh import collective_counts

    tr = ctx.trace
    seconds = None if tr is None else tr.op_seconds(PATTERNS)
    counts = collective_counts()
    nbytes = sum(counts.get(k, 0) for k in KINDS)
    steps = ctx.layer.get("steps")
    if not seconds or not nbytes or not steps:
        return None
    run_steps = steps + ctx.params.get("warm_steps", 0)
    return nbytes * steps / run_steps / seconds / 1e9
