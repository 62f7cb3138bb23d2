"""``perfbench/phases.py``: its reduction on hand-made events (a kernel goes
to the span its launch fell in, a synchronise outside the program's spans is
not counted, an idle gap is labelled ``<benchmark span>/<program span>``,
nothing is read from a tree without the program's spans), and one toy run of
a cell on one process and on two gloo ranks."""

from __future__ import annotations

import pytest
import torch

from perfbench import phases
from perfbench.harness.trace import Trace
from perfbench.tests.test_perfbench_drivers import SEED, toy
from viscoin_tpu_torch.utils import tracing

US = 1_000  # ns


def viscoin_window():
    """One VisCoIN step and one sampler call in a 1 ms window: kernel A
    launched in the step, B launched in its backward and run after the span
    closed, C launched in ``sample``; one synchronise in the backward and one
    between the program's spans."""
    tr = Trace(ops=[(100 * US, 200 * US, "kernel_a"), (520 * US, 560 * US, "kernel_b"),
                    (700 * US, 800 * US, "kernel_c")],
               spans=[(0, 600 * US, "step"), (600 * US, 1000 * US, "sampler")],
               t0=0, t1=1000 * US)
    ev = phases.Events(
        vt=[(10 * US, 500 * US, "viscoin_step"), (300 * US, 480 * US, "viscoin_step.backward"),
            (620 * US, 900 * US, "sample")],
        ops=[(100 * US, 200 * US, "kernel_a", 1), (520 * US, 560 * US, "kernel_b", 2),
             (700 * US, 800 * US, "kernel_c", 3)],
        launches={1: 50 * US, 2: 400 * US, 3: 650 * US},
        syncs=[(420 * US, 430 * US, "cudaStreamSynchronize"),
               (590 * US, 595 * US, "cudaDeviceSynchronize")])
    return tr, ev


def test_a_kernel_goes_to_the_span_its_launch_fell_in():
    tr, ev = viscoin_window()
    out = phases.analyse(tr, ev, steps=1, tops=phases.TOPS["train_viscoin"])
    assert out["launches_per_step"] == 3
    assert out["device_s_by_phase"] == pytest.approx(
        {"viscoin_step": 100e-6, "viscoin_step.backward": 40e-6, "sample": 100e-6})
    assert out["host_us_per_launch"] == pytest.approx((490 + 280) / 3)
    assert out["sampler_device_pct"] == pytest.approx(10.0)


def test_a_synchronise_outside_the_program_spans_is_not_counted():
    tr, ev = viscoin_window()
    out = phases.analyse(tr, ev, steps=1, tops=phases.TOPS["train_viscoin"])
    assert out["host_syncs_per_step"] == 1
    assert out["syncs_by_phase"] == {"viscoin_step.backward:cudaStreamSynchronize": 1}


def test_an_idle_gap_is_labelled_by_both_spans():
    tr, ev = viscoin_window()
    assert phases.idle_by_phase(tr, ev) == pytest.approx({
        "step/viscoin_step": 320e-6, "sampler/sample": 200e-6, "step": 240e-6})
    out = phases.analyse(tr, ev, steps=1, tops=phases.TOPS["train_viscoin"])
    assert out["step_idle_named_share"] == pytest.approx(320 / 560)


def test_regularised_gan_steps_are_found_by_their_children():
    tr = Trace(ops=[(300 * US, 400 * US, "r1_kernel"), (600 * US, 650 * US, "plain_kernel")],
               spans=[(0, 450 * US, "reg_step"), (450 * US, 1000 * US, "plain_step")],
               t0=0, t1=1000 * US)
    ev = phases.Events(
        vt=[(0, 400 * US, "gan_step"), (100 * US, 200 * US, "gan_step.d_forward"),
            (120 * US, 180 * US, "gan_step.r1"), (500 * US, 900 * US, "gan_step")],
        ops=[(300 * US, 400 * US, "r1_kernel", 7), (600 * US, 650 * US, "plain_kernel", 8)],
        launches={7: 150 * US, 8: 550 * US})
    out = phases.analyse(tr, ev, steps=2, tops=phases.TOPS["train_gan"])
    assert out["gan_reg_device_pct"] == pytest.approx(10.0)
    assert out["device_s_by_phase"] == pytest.approx({"gan_step.r1": 100e-6,
                                                      "gan_step": 50e-6})


def test_crossing_spans_of_two_threads_still_give_an_open_span():
    inner = phases.Innermost([(0, 100, "a"), (10, 20, "b"), (15, 150, "other_thread")])
    assert inner(17)[2] == "other_thread"
    assert inner(50)[2] == "other_thread"
    assert inner(120)[2] == "other_thread"
    assert inner(160) is None


def test_the_gradient_all_reduce_is_timed_by_its_span():
    tr = Trace(ops=[(300 * US, 500 * US, "ncclDevKernel_AllReduce_Sum_f32_RING_LL"),
                    (700 * US, 710 * US, "ncclDevKernel_AllReduce_Max_f32")],
               t0=0, t1=1000 * US)
    ev = phases.Events(vt=[(100 * US, 200 * US, "dp.allreduce_grads")],
                       ops=[(300 * US, 500 * US, "ncclDevKernel_AllReduce_Sum_f32_RING_LL", 1),
                            (700 * US, 710 * US, "ncclDevKernel_AllReduce_Max_f32", 2)],
                       launches={1: 150 * US, 2: 650 * US})
    out = phases.allreduce(tr, ev, {"grad_bytes": 2_000_000, "mean_bytes": 24})
    assert out["allreduce_grads_s"] == pytest.approx(200e-6)
    assert out["nccl_s"] == pytest.approx(210e-6)
    assert out["grad_gbps"] == pytest.approx(2_000_000 / 200e-6 / 1e9)


def test_nothing_is_read_without_the_program_spans():
    tr, ev = viscoin_window()
    ev.vt = []
    assert phases.analyse(tr, ev, steps=1, tops=phases.TOPS["train_viscoin"]) == {}
    assert phases.allreduce(tr, ev, {"grad_bytes": 1}) is None


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def test_a_toy_gan_run_records_the_program_spans(few_threads):
    span = tracing.span
    wl, config = toy("stylegan2ada-256.train")
    out = phases.run("stylegan2ada-256.train", wl, config, SEED, 0.5, device_type="cpu")
    assert out["correct"] and out["steps"] >= 16
    names = set(out["host_s_by_span"])
    assert {"gan_draw", "gan_step", "gan_step.g_forward", "gan_step.d_forward",
            "gan_step.r1", "gan_step.path_length", "gan_step.ema_ada"} <= names
    assert tracing.span is span  # the tool leaves the program as it found it
    stubbed = phases.run("stylegan2ada-256.train", wl, config, SEED, 0.5, stub=True,
                         device_type="cpu")
    assert stubbed["correct"] and "host_s_by_span" not in stubbed
    assert tracing.span is span


def test_two_gloo_ranks_count_the_window_all_reduce():
    wl, config = toy("stylegan2ada-256.train")
    wl = dict(wl, chips=4)
    out = phases.run("stylegan2ada-256.train-dp4", wl, config, SEED, 0.5, world=2,
                     device_type="cpu", timeout_s=600)
    assert out["correct"]
    ar = out["allreduce"]
    # G's and D's gradients a step, counted over the window's steps alone
    assert ar["calls"] == 2 * out["steps"] and ar["grad_bytes"] > 0 and ar["mean_bytes"] > 0
    assert ar["grad_bytes"] % out["steps"] == 0


def test_a_toy_viscoin_run_records_the_program_spans(few_threads):
    wl, config = toy("viscoin-cub256.train")
    out = phases.run("viscoin-cub256.train", wl, config, SEED, 0.5, device_type="cpu")
    assert out["correct"] and out["steps"] >= 2
    assert {"sample", "viscoin_step", "viscoin_step.preprocess", "viscoin_step.classifier",
            "viscoin_step.concepts", "viscoin_step.synthesis", "viscoin_step.f_rebuilt",
            "viscoin_step.lpips", "viscoin_step.backward",
            "viscoin_step.update"} <= set(out["host_s_by_span"])
