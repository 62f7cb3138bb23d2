"""The ``allreduce_gbps`` reader on hand-made traces and counts: the
program's counted bytes per step of the run, times the window's steps, over
the NCCL kernels' time; nothing read where the program counts neither the
gradient all-reduce nor the means (as before it counted them), or where the
window ran no NCCL kernel."""

from __future__ import annotations

import pytest

from perfbench.harness import core
from perfbench.harness.trace import Trace
from viscoin_tpu_torch.parallel import mesh as M

CELL = "stylegan2ada-256.train-dp4"


@pytest.fixture
def ctx():
    wl = core.load_json(core.workload_file(CELL))
    c = core.Context(cell=CELL, wl=wl, config={}, seed=1, seconds=1.0, traced=True, t_start=0.0)
    c.trace = Trace(ops=[(0, 500_000_000, "ncclDevKernel_AllReduce_Sum_f32_RING_LL"),
                         (500_000_000, 2_000_000_000, "sm80_xmma_fprop_implicit_gemm"),
                         (2_000_000_000, 2_500_000_000, "ncclDevKernel_AllReduce_Sum_f32")],
                    t0=0, t1=3_000_000_000)
    c.layer["steps"] = 15  # the window's, after the cell's 5 set-up steps
    M.reset_collective_counts()
    yield c
    M.reset_collective_counts()


def reader():
    return core.metric_reader("allreduce_gbps")


def test_bytes_per_step_times_the_window_steps_over_nccl_time(ctx):
    for _ in range(20):  # 5 set-up + 15 window steps, G's and D's gradients and 3 means each
        M.count_collective("grad", 100_000_000)
        M.count_collective("grad", 150_000_000)
        for _ in range(3):
            M.count_collective("mean", 8)
    per_step = 250_000_000 + 24
    assert reader().read(ctx) == pytest.approx(per_step * 15 / 1.0 / 1e9)


def test_nothing_is_read_without_counted_kinds(ctx):
    M.count_collective("halo", 1_000)  # the model group's kinds are not these
    assert reader().read(ctx) is None


def test_nothing_is_read_without_nccl_kernels_or_a_trace(ctx):
    M.count_collective("grad", 1_000)
    ctx.trace.ops = [op for op in ctx.trace.ops if "nccl" not in op[2]]
    assert reader().read(ctx) is None
    ctx.trace = None
    assert reader().read(ctx) is None
