"""The spans and counters of the port's training steps
(``viscoin_tpu_torch/utils/tracing.py``, ``parallel/mesh.py``) on the CPU at
toy widths: under ``torch.profiler`` the VisCoIN loop and the GAN step
record each named span once per step, nested as documented, the
regularisers' spans only on their cadence and the sampler's once per K-step
group; without a profiler a span is one shared no-op, and the steps compute
bit for bit what they compute with the helper stubbed out (with a profiler
too); on a 2-rank gloo mesh ``collective_counts`` counts the gradient
all-reduce and the means of a GAN step; ``train_viscoin``'s timings keep
their keys; the VisCoIN step's route to its CUDA graph or to the eager
step, and the counter of how each step ran."""

import contextlib
import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_loop import B, IMG, run, tiny
from torch_dp_worker import Ranks, gan_inputs
from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from viscoin_tpu_torch.train import gan as TG
from viscoin_tpu_torch.train import viscoin as T
from viscoin_tpu_torch.utils import tracing

VISCOIN_CHILDREN = ("preprocess", "classifier", "concepts", "synthesis", "f_rebuilt", "lpips",
                    "backward", "update")
GAN_CHILDREN = ("g_forward", "g_backward", "g_update", "d_forward", "d_backward", "d_update",
                "ema_ada")
# R1 every 3 steps, the path length every 2: over steps 0-2, R1 at 0, the
# path length at 0 and 2; ADA adjusts after step 1.
GAN_CFG = dict(batch_size=4, augment_p=0.2, r1_interval=3, ppl_interval=2, ada_interval=2,
               ema_kimg=0.01, style_mixing_prob=0.5)
GAN_STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def gloo_workers(tmp_path_factory):
    """The two gloo ranks of the counting test (a plain step, 1, and one
    with both regularisers, 0), started before this module's first test so
    that they run beside it."""
    inp = gan_inputs()
    inp.update(steps=(1, 0), images=inp["images"][:2])
    workers = Ranks(tmp_path_factory.mktemp("counts"), {"gan_counts": inp}, 2)
    yield workers
    for p in workers.procs:  # left running when the counting test was not selected
        if p.poll() is None:
            p.kill()
            p.communicate(timeout=30)


def recorded(prof) -> list[tuple[int, int, str]]:
    """The profiler's ``vt.*`` spans as (start_ns, end_ns, name without the
    prefix), in start order."""
    return sorted((e.start_ns(), e.end_ns(), e.name()[len(tracing.PREFIX):])
                  for e in prof.profiler.kineto_results.events()
                  if e.is_user_annotation() and e.name().startswith(tracing.PREFIX))


def inside(spans, outer: str) -> list[list[str]]:
    """For each span named ``outer``, the names of the spans within it."""
    return [[n for s, e, n in spans if s0 <= s and e <= e0 and (s, e, n) != (s0, e0, o)]
            for s0, e0, o in spans if o == outer]


def gan_modules():
    inp = gan_inputs()
    return inp["g"], inp["d"], inp["images"][0][: GAN_CFG["batch_size"]]


def gan_steps(g, d, images, steps: int = GAN_STEPS):
    """``steps`` GAN steps from a fresh state: every step's metrics and the
    state's tensors after them."""
    cfg = TG.GANTrainingParams(**GAN_CFG)
    state = TG.create_gan_train_state(g, d, cfg)
    step = TG.make_gan_train_step(g, d, cfg)
    metrics = []
    for i in range(steps):
        draws = TG.draw_step(cfg, g, 3, i, "cpu")
        metrics.append({k: v.clone() for k, v in step(state, images, draws)[1].items()})
    tensors = {**{f"G.{n}": t for n, t in g.state_dict().items()},
               **{f"D.{n}": t for n, t in d.state_dict().items()},
               **{f"G_ema.{n}": t for n, t in state.g_ema.state_dict().items()},
               "w_avg": state.w_avg, "pl_mean": state.pl_mean, "ada_p": state.ada_p,
               "ada_rt": state.ada_rt}
    return metrics, tensors


def viscoin_steps(n: int = 2):
    """``n`` VisCoIN steps of the toy bundle on one presampled group: the
    metrics and the trained parameters after them."""
    m, gen, lpips = tiny()
    cfg = T.VisCoINTrainingParams(iterations=10, batch_size=B, cd_fid_iteration=-1,
                                  fake_presample_steps=n)
    frozen = T.make_frozen(m, gen, lpips)
    state = T.create_train_state(m, cfg)
    step = T.make_train_step(m, gen, lpips, cfg, external_fakes=True)
    fakes = T.make_sample_fakes(gen, cfg)(frozen, T.fake_sample_keys(0, 0, n))
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 4, B))
    metrics = []
    for i in range(n):
        _, out = step(state, frozen, images, labels, T.step_generator(0, i, "cpu"), fakes[i])
        metrics.append(out)
    return metrics, {f"{g}.{k}": p.detach().clone() for g, grp in state.params.items()
                     for k, p in grp.items()}


def test_a_span_without_profiler_is_one_shared_no_op():
    first, second = tracing.span("gan_step"), tracing.span("viscoin_step.backward")
    assert first is second
    with first, second:
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("x"):
            torch.ones(2).add_(1)
    assert [n for _, _, n in recorded(prof)] == ["x"]


def test_viscoin_loop_spans_nesting_cadence_and_timings(tmp_path):
    """4 steps of the loop with K = 2, eval and checkpoints every 2 steps
    and the probe every 2 (i > 0): each step span and each of its eight
    children once per step, every child inside a ``viscoin_step``; the
    sampler once per group, outside the steps; the loop's phases at their
    cadence; ``timings`` with its keys, one duration per phase block."""
    timings = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(str(tmp_path), 4, eval_every=2, checkpoint_every=2, faithfulness_every=2,
            timings=timings)
    spans = recorded(prof)
    names = [n for _, _, n in spans]
    want = {"viscoin_step": 4, "sample": 2, "loop.data": 4, "loop.eval": 2,
            "loop.checkpoint": 2, "loop.probe": 1,
            **{f"viscoin_step.{c}": 4 for c in VISCOIN_CHILDREN}}
    assert {n: names.count(n) for n in set(names)} == want
    for children in inside(spans, "viscoin_step"):
        assert sorted(children) == sorted(f"viscoin_step.{c}" for c in VISCOIN_CHILDREN)
    for outer in ("sample", "loop.data"):
        assert inside(spans, outer) == [[]] * want[outer]
    steps = [(s, e) for s, e, n in spans if n == "viscoin_step"]
    for s, e, n in spans:  # the sampler and the loop's phases lie outside every step
        if not n.startswith("viscoin_step"):
            assert not any(s0 <= s < e0 for s0, e0 in steps), n
    assert set(timings) == {"steps", "n_steps", "max_steps", "eval", "n_eval", "max_eval",
                            "checkpoint", "n_checkpoint", "max_checkpoint", "probe",
                            "n_probe", "max_probe", "seconds"}
    for phase, n in (("steps", 4), ("eval", 2), ("checkpoint", 2), ("probe", 1)):
        assert timings[f"n_{phase}"] == n and len(timings["seconds"][phase]) == n
        assert timings[phase] == pytest.approx(sum(timings["seconds"][phase]))
        assert timings[f"max_{phase}"] == max(timings["seconds"][phase]) > 0


def test_gan_step_spans_nesting_and_cadence():
    """Steps 0-2 (R1 at 0, the path length at 0 and 2): each step's
    draw and step spans once, the step's seven phase spans once inside it,
    ``.r1`` inside ``.d_forward`` and ``.path_length`` between the G
    backward and the G update, each only on its cadence."""
    g, d, images = gan_modules()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gan_steps(g, d, images)
    spans = recorded(prof)
    assert [n for _, _, n in spans if n in ("gan_draw", "gan_step")] == \
        ["gan_draw", "gan_step"] * GAN_STEPS
    assert inside(spans, "gan_draw") == [[]] * GAN_STEPS
    per_step = inside(spans, "gan_step")
    for i, children in enumerate(per_step):
        regs = {n for n, on in (("gan_step.r1", i % 3 == 0),
                                ("gan_step.path_length", i % 2 == 0)) if on}
        order = [f"gan_step.{c}" for c in GAN_CHILDREN[:2]]
        order += ["gan_step.path_length"] * (i % 2 == 0)
        order += ["gan_step.g_update", "gan_step.d_forward"]
        order += ["gan_step.r1"] * (i % 3 == 0)
        order += [f"gan_step.{c}" for c in GAN_CHILDREN[4:]]
        assert children == order, i
        assert set(children) - {f"gan_step.{c}" for c in GAN_CHILDREN} == regs
    d_fwd = inside(spans, "gan_step.d_forward")
    assert d_fwd == [["gan_step.r1"] if i % 3 == 0 else [] for i in range(GAN_STEPS)]


@contextlib.contextmanager
def stubbed():
    """``tracing.span`` replaced by a fresh no-op context per call."""
    span = tracing.span
    tracing.span = lambda name: contextlib.nullcontext()
    try:
        yield
    finally:
        tracing.span = span


@pytest.mark.parametrize("profiled", [False, True], ids=["no_profiler", "profiler"])
@pytest.mark.parametrize("steps", ["viscoin", "gan"])
def test_steps_are_bit_equal_with_the_helper_stubbed_out(steps, profiled):
    """Two VisCoIN steps, or two GAN steps (both regularisers, then an ADA
    adjustment): every metric and every trained, EMA and ADA tensor equal
    bit for bit to the same steps with ``tracing.span`` stubbed out."""
    if steps == "gan":
        g, d, images = gan_modules()
        run_steps = lambda: gan_steps(copy.deepcopy(g), copy.deepcopy(d), images, 2)  # noqa: E731
    else:
        run_steps = viscoin_steps
    runs = []
    for stub in (False, True):
        ctx = profile(activities=[ProfilerActivity.CPU]) if profiled and not stub else \
            contextlib.nullcontext()
        with ctx, (stubbed() if stub else contextlib.nullcontext()):
            runs.append(run_steps())
    (metrics_a, tensors_a), (metrics_b, tensors_b) = runs
    for a, b in [*zip(metrics_a, metrics_b), (tensors_a, tensors_b)]:
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_gloo_mesh_counts_the_gradient_all_reduce_and_the_means(gloo_workers):
    """A plain step (1) and one with both regularisers (0) on each of two
    gloo ranks: "grad" counts one all-reduce for G's gradients and one for
    D's (one dtype each) of exactly their parameters' bytes; "mean" counts
    the batch mean of w, ADA's r_t and the step's three losses, and on the
    path-length step the global path-length mean and its backward."""
    for out in gloo_workers.join():
        got = out["gan_counts"]
        grad_bytes = got["param_bytes"]["G"] + got["param_bytes"]["D"]
        plain, reg = got["counts"]
        for counts in (plain, reg):
            assert counts["grad"] == 2 and counts["grad_bytes"] == grad_bytes
        assert plain["mean"] == 3 and plain["mean_bytes"] == 4 * (got["w_dim"] + 1 + 3)
        assert reg["mean"] == 5 and reg["mean_bytes"] == 4 * (got["w_dim"] + 1 + 3 + 2)
        assert not {k for c in (plain, reg) for k in c} - {"grad", "grad_bytes", "mean",
                                                            "mean_bytes"}


def test_spatial_counts_keep_their_own_kinds():
    """The model group's counts read their kinds alone: the data-parallel
    counters beside them do not enter ``spatial.counts()``."""
    from viscoin_tpu_torch.parallel import mesh as M
    from viscoin_tpu_torch.parallel import spatial as S

    S.reset_counts()
    M.count_collective("grad", 64)
    M.count_collective("mean", 4)
    assert M.collective_counts()["grad_bytes"] == 64
    assert set(S.counts()) == {"halo", "halo_bytes", "gather", "gather_bytes", "scatter", "sum",
                               "sum_bytes"}
    assert not any(S.counts().values())
    S.reset_counts()



@pytest.mark.parametrize("device,mesh,remat,want", [
    ("cpu", None, "", "not_cuda"),
    ("cpu", SimpleNamespace(model_axis=object()), "lpips", "not_cuda"),
    ("cuda", SimpleNamespace(model_axis=object()), "", "model_parallel"),
    ("cuda", SimpleNamespace(model_axis=object()), "gan", "model_parallel"),
    ("cuda", None, "lpips", "remat"),
    ("cuda", None, "gan+classifier", "remat"),
    ("cuda", SimpleNamespace(model_axis=None), "", None),  # data parallelism alone
    ("cuda", None, "", None),
], ids=["cpu", "cpu_remat_model_axis", "model_axis", "model_axis_remat", "remat",
        "remat_two", "data_parallel", "card"])
def test_eager_reason_routes_the_step(device, mesh, remat, want):
    """Eager on the CPU, with a model axis and with remat; the CUDA graph on
    a card, with or without a data-parallel mesh."""
    assert T.eager_reason(torch.device(device), mesh, remat) == want


def test_cpu_steps_count_as_eager_with_their_reason():
    """Every step on the CPU is counted eager, under "not_cuda"."""
    tracing.reset_graph_counts()
    viscoin_steps(2)
    assert tracing.graph_counts() == {"eager": 2, "eager.not_cuda": 2}
    tracing.reset_graph_counts()
    assert tracing.graph_counts() == {}


def test_a_failed_capture_warns_once_and_the_steps_stay_eager(monkeypatch):
    """Routed to the graph where no capture can start (the CPU, where
    torch raises a RuntimeError as CUDA does when it refuses a capture),
    the first step warns once, every step runs eagerly under "capture_failed" and
    computes what the eager step computes, bit for bit."""
    want_metrics, want_tensors = viscoin_steps(3)
    monkeypatch.setattr(T, "eager_reason", lambda *a, **k: None)
    tracing.reset_graph_counts()
    with pytest.warns(RuntimeWarning, match="capture failed") as caught:
        metrics, tensors = viscoin_steps(3)
    assert sum("capture failed" in str(w.message) for w in caught) == 1
    assert tracing.graph_counts() == {"eager": 3, "eager.capture_failed": 3}
    for a, b in [*zip(metrics, want_metrics), (tensors, want_tensors)]:
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_an_error_other_than_a_capture_refusal_raises(monkeypatch):
    """Only a RuntimeError, what CUDA's refusals raise, sends the step
    back to the eager path: any other error inside the capture raises and
    counts no step."""

    def broken(*a, **k):
        raise TypeError("a fault of the step's own code")

    monkeypatch.setattr(T, "eager_reason", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "Stream", broken)
    tracing.reset_graph_counts()
    with pytest.raises(TypeError, match="own code"):
        viscoin_steps(1)
    assert tracing.graph_counts() == {}


def test_add_launches_counts_what_no_wrapper_counted():
    """A replay adds its capture's launches; a capture takes its own back."""
    from viscoin_tpu_torch.ops import _kernels

    _kernels.reset_launch_counts()
    _kernels.count_launch("bias_act")
    _kernels.add_launches({"bias_act": 3, "upfirdn2d": 2}, 2)
    assert _kernels.launch_counts() == {"bias_act": 7, "bias_act_grad": 0, "upfirdn2d": 4}
    _kernels.add_launches({"bias_act": 7, "upfirdn2d": 4}, -1)
    assert set(_kernels.launch_counts().values()) == {0}


def test_step_metrics_are_not_aliased_between_calls():
    """Two calls' metrics are tensors of their own: no storage shared, and
    the first call's values stay what they were after the second."""
    (first, second), _ = viscoin_steps(2)
    kept = {k: v.clone() for k, v in first.items()}
    assert first.keys() == second.keys() == set(T.TRAIN_METRICS) | {"total_loss"}
    for k in first:
        assert first[k].untyped_storage().data_ptr() != second[k].untyped_storage().data_ptr()
        assert torch.equal(first[k], kept[k]), k
