"""A cell's traced run with the program's own spans read: where the host was
when the card ran dry, and what each phase of the step launched.

    python3 perfbench/phases.py --workload <cell> --seed <n> [--seconds 30] [--stub] [--out FILE]
    python3 perfbench/phases.py --span-cost [--out FILE]

The cell's driver runs as in a ``--trace 1`` run (one process per card), and
the trace of its window is read beyond what ``harness/trace.py::reduce``
keeps: the ``vt.*`` spans of ``viscoin_tpu_torch/utils/tracing.py``, each
device operation's launch (the host's runtime call with the same correlation
id) and the host's blocking runtime calls. The program's data-parallel
counters (``parallel/mesh.py::collective_counts``) are reset at the window's
start and read at its end. Rank 0 prints one JSON line:

  * ``launches_per_step``: device operations launched inside the step's
    top-level spans (``viscoin_step`` and ``sample``, or ``gan_draw`` and
    ``gan_step``), per step; ``host_us_per_launch``: those spans' host time
    over the operations launched in them;
  * ``host_syncs_per_step``: blocking runtime calls that start inside a
    program span (the benchmark's own synchronises lie outside them), and
    ``syncs_by_phase`` by the innermost span;
  * ``sampler_device_pct`` (VisCoIN): device time of what ``sample``
    launched, over the window; ``gan_reg_device_pct`` (GAN): device time of
    what the steps whose ``gan_step`` holds ``.r1`` or ``.path_length``
    launched, over the window;
  * ``idle_by_phase``: the window's idle device time by
    ``<benchmark span>/<innermost program span>`` open when each gap began
    (the benchmark's label alone where no program span was open), and
    ``step_idle_named_share``, the share of the idle inside the benchmark's
    step spans that carries a program phase;
  * ``device_s_by_phase``: device time by the innermost program span its
    operation was launched in; ``host_s_by_span``: each span's host time;
  * on several cards, ``allreduce``: the NCCL kernels launched inside
    ``dp.allreduce_grads`` (their device time on rank 0's card, which holds
    the wait for the slowest rank), the window's counted "grad" and "mean"
    bytes, and the gradient bytes over those kernels' time.

``--stub`` replaces ``tracing.span`` by its no-op (the spans' cost under the
profiler: the same run without them). ``--span-cost`` times one span on the
host, off and under a profiler. Runs on the card; the reduction's functions
are tested on hand-made events on the CPU (``perfbench/tests/test_perfbench_phases.py``).
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.harness import core, runner, trace  # noqa: E402

VT = "vt."
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
TOPS = {"train_viscoin": ("viscoin_step", "sample"), "train_gan": ("gan_draw", "gan_step")}
STEP_SPANS = ("step", "plain_step", "reg_step")  # the benchmark's spans around a step
REG_CHILDREN = ("gan_step.r1", "gan_step.path_length")
NCCL = ("nccl", "Nccl")


@dataclass
class Events:
    """What the reduction keeps beyond :class:`~perfbench.harness.trace.Trace`,
    on the profiler's clock: the program's spans (start, end, name without
    ``vt.``), device operations (start, end, name, correlation id), launch
    times by correlation id, and blocking runtime calls (start, end, name)."""

    vt: list = field(default_factory=list)
    ops: list = field(default_factory=list)
    launches: dict = field(default_factory=dict)
    syncs: list = field(default_factory=list)


def collect(prof) -> Events:
    """The profiler's events, as :class:`Events`."""
    from torch.autograd import DeviceType

    ev = Events()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                ev.ops.append((e.start_ns(), e.end_ns(), name, e.correlation_id()))
        elif e.is_user_annotation():
            if name.startswith(VT):
                ev.vt.append((e.start_ns(), e.end_ns(), name[len(VT):]))
        elif name.startswith("cu"):
            if e.correlation_id():
                ev.launches[e.correlation_id()] = e.start_ns()
            if name in SYNCS:
                ev.syncs.append((e.start_ns(), e.end_ns(), name))
    ev.vt.sort()
    ev.ops.sort()
    ev.syncs.sort()
    return ev


class Innermost:
    """The innermost of nested (start, end, name) spans open at a time: the
    latest-started span still open, found through each span's parent (the
    span open when it began). Spans of the autograd engine's thread may
    cross the main thread's; the lookup then still returns an open span."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda x: (x[0], -x[1]))
        self.starts = [s for s, _, _ in self.spans]
        self.parent, stack = [], []
        for i, (s, _, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] <= s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def __call__(self, t):
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0:
            if self.spans[j][1] > t:
                return self.spans[j]
            j = self.parent[j]
        return None


def idle_gaps(ops, t0: int, t1: int) -> list[tuple[int, int]]:
    """The window's stretches with no device operation (as ``Trace.busy_s``
    unions them)."""
    gaps, end = [], t0
    for op in sorted(ops):
        s, e = op[0], op[1]
        if s > end:
            gaps.append((end, min(s, t1)))
        end = max(end, e)
    if end < t1:
        gaps.append((end, t1))
    return [(s, e) for s, e in gaps if e > s]


def idle_by_phase(tr, ev: Events) -> dict[str, float]:
    """Idle seconds by ``<benchmark span>/<innermost program span>`` open
    when each gap began; the benchmark's label alone where no program span
    was open, "outside spans" where neither was."""
    bench, prog = Innermost(tr.spans), Innermost(ev.vt)
    out: dict[str, float] = {}
    for gs, ge in idle_gaps(tr.ops, tr.t0, tr.t1):
        b, v = bench(gs), prog(gs)
        label = (b[2] if b else "outside spans") + (f"/{v[2]}" if v else "")
        out[label] = out.get(label, 0.0) + (ge - gs) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _clipped(op, t0: int, t1: int) -> float:
    return max(0, min(op[1], t1) - max(op[0], t0)) / 1e9


def analyse(tr, ev: Events, steps: int, tops: tuple[str, ...]) -> dict:
    """The phase metrics of one traced window (``tr`` the benchmark's
    reduced trace, ``steps`` the window's steps); an empty dict where the
    program has no spans (a tree before them)."""
    t0, t1 = tr.t0, tr.t1
    vt = [s for s in ev.vt if s[1] > t0 and s[0] < t1]
    if not vt or not steps:
        return {}
    ops = [op for op in ev.ops if op[1] > t0 and op[0] < t1]
    launched = [(op, ev.launches.get(op[3])) for op in ops]
    inner = Innermost(vt)
    top = [s for s in vt if s[2] in tops]
    in_top = Innermost(top)
    mine = [(op, sp) for op, t in launched if t is not None and (sp := in_top(t))]
    out = {"steps": steps, "window_s": tr.window_s, "ops": len(ops),
           "ops_with_launch": sum(1 for _, t in launched if t is not None),
           "launches_per_step": len(mine) / steps,
           "host_us_per_launch": (sum(e - s for s, e, _ in top) / 1e3 / len(mine)
                                  if mine else None)}
    syncs = [s for s in ev.syncs if t0 <= s[0] < t1]
    by_phase: dict[str, int] = {}
    for s in syncs:
        sp = inner(s[0])
        if sp is not None:
            key = f"{sp[2]}:{s[2]}"
            by_phase[key] = by_phase.get(key, 0) + 1
    out["host_syncs_per_step"] = sum(by_phase.values()) / steps
    out["syncs_by_phase"] = dict(sorted(by_phase.items(), key=lambda kv: -kv[1]))
    device: dict[str, float] = {}
    for op, t in launched:
        sp = inner(t) if t is not None else None
        key = sp[2] if sp else "(outside spans)"
        device[key] = device.get(key, 0.0) + _clipped(op, t0, t1)
    out["device_s_by_phase"] = dict(sorted(device.items(), key=lambda kv: -kv[1]))
    host: dict[str, float] = {}
    for s, e, n in vt:
        host[n] = host.get(n, 0.0) + (e - s) / 1e9
    out["host_s_by_span"] = dict(sorted(host.items(), key=lambda kv: -kv[1]))
    if "sample" in tops:
        out["sampler_device_pct"] = 100 * sum(
            _clipped(op, t0, t1) for op, sp in mine if sp[2] == "sample") / tr.window_s
    if "gan_step" in tops:
        reg = {s for s in top if s[2] == "gan_step"
               and any(c[2] in REG_CHILDREN and s[0] <= c[0] and c[1] <= s[1] for c in vt)}
        out["gan_reg_device_pct"] = 100 * sum(
            _clipped(op, t0, t1) for op, sp in mine if sp in reg) / tr.window_s
    idle = idle_by_phase(tr, ev)
    out["idle_pct"] = 100 * (1 - tr.busy_s() / tr.window_s)
    out["idle_by_phase"] = idle
    step_idle = {k: v for k, v in idle.items() if k.split("/")[0] in STEP_SPANS}
    total = sum(step_idle.values())
    out["step_idle_s"] = total
    out["step_idle_named_share"] = (sum(v for k, v in step_idle.items() if "/" in k) / total
                                    if total else None)
    return out


def allreduce(tr, ev: Events, counts: dict) -> dict | None:
    """The gradient all-reduce on this rank: the NCCL kernels launched inside
    ``dp.allreduce_grads`` (their device time holds the wait for the slowest
    rank), the window's counted bytes, and the gradient bytes over that time;
    None where the program has no such span."""
    spans = [s for s in ev.vt if s[2] == "dp.allreduce_grads" and s[1] > tr.t0 and s[0] < tr.t1]
    if not spans:
        return None
    inside = Innermost(spans)
    seconds = sum(_clipped(op, tr.t0, tr.t1) for op in ev.ops
                  if any(p in op[2] for p in NCCL)
                  and (t := ev.launches.get(op[3])) is not None and inside(t))
    nccl = tr.op_seconds(NCCL) or 0.0
    grad = counts.get("grad_bytes", 0)
    return {"calls": len(spans), "grad_bytes": grad, "mean_bytes": counts.get("mean_bytes", 0),
            "allreduce_grads_s": seconds, "nccl_s": nccl,
            "grad_gbps": grad / seconds / 1e9 if seconds else None}


# ------------------------------- the run ----------------------------------- #


class _Recorder:
    """While entered, lays the extended reduction over ``harness/trace.py``
    in this process: ``reduce`` also keeps :class:`Events`, ``window``
    resets the program's collective counters at its start and keeps them at
    its end; with ``stub`` the program's spans are no-ops."""

    def __init__(self, stub: bool = False):
        self.stub = stub
        self.events: Events | None = None
        self.counts: dict = {}

    def __enter__(self):
        from viscoin_tpu_torch.parallel import mesh
        from viscoin_tpu_torch.utils import tracing

        self._saved = trace.reduce, trace.window, tracing.span
        reduce, window = trace.reduce, trace.window

        def reduce_more(prof, t0_ns, t1_ns):
            self.events = collect(prof)
            return reduce(prof, t0_ns, t1_ns)

        @contextlib.contextmanager
        def counted_window(enabled):
            mesh.reset_collective_counts()
            with window(enabled) as w:
                yield w
            self.counts = dict(mesh.collective_counts())

        trace.reduce, trace.window = reduce_more, counted_window
        if self.stub:
            tracing.span = lambda name: tracing._OFF
        return self

    def __exit__(self, *exc):
        from viscoin_tpu_torch.utils import tracing

        trace.reduce, trace.window, tracing.span = self._saved


def run_rank(cell: str, wl: dict, config: dict, seed: int, seconds: float, stub: bool,
             rank: int = 0, world: int = 1, port: int = 0, device=None) -> dict | None:
    """The cell's driver on this rank, traced; rank 0's phase metrics."""
    import torch

    if device is None:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    ctx = core.Context(cell=cell, wl=wl, config=config, seed=seed, seconds=seconds, traced=True,
                       t_start=time.time(), rank=rank, world=world, device=device)
    ctx.layer["port"] = port
    with _Recorder(stub) as rec:
        core.driver(wl["driver"]).run(ctx)
    if rank != 0:
        return None
    tr, ev = ctx.trace, rec.events or Events()
    out = {"workload": cell, "seed": seed, "stub": stub, "world": world,
           "correct": bool(ctx.checks) and all(v <= lim for v, lim in ctx.checks.values()),
           "step_ms": 1e3 * ctx.layer["window_s"] / ctx.layer["steps"]}
    out.update(analyse(tr, ev, ctx.layer["steps"], TOPS[wl["driver"]]))
    if world > 1:
        out["allreduce"] = allreduce(tr, ev, rec.counts)
    return out


def _child(queue, args: tuple, rank: int, world: int, port: int, device_type: str) -> None:
    import torch

    device = None
    if device_type == "cpu":
        device = torch.device("cpu")
        torch.set_num_threads(2)
    try:
        queue.put((rank, run_rank(*args, rank=rank, world=world, port=port, device=device)))
    except BaseException:
        import traceback

        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def run(cell: str, wl: dict, config: dict, seed: int, seconds: float, stub: bool = False,
        world: int = 1, device_type: str = "cuda", timeout_s: float = 1500) -> dict:
    """One traced run of the cell over ``world`` processes (one in this
    process on one card); rank 0's phase metrics."""
    args = (cell, wl, config, seed, seconds, stub)
    if world == 1:
        import torch

        device = torch.device("cpu") if device_type == "cpu" else None
        return run_rank(*args, device=device)
    import multiprocessing as mp

    mpc = mp.get_context("spawn")
    queue, port = mpc.Queue(), runner.free_port()
    procs = [mpc.Process(target=_child, args=(queue, args, r, world, port, device_type))
             for r in range(world)]
    for p in procs:
        p.start()
    out = None
    try:
        for _ in range(world):
            rank, res = queue.get(timeout=timeout_s)
            if res is not None and "error" in res:
                raise RuntimeError(f"rank {rank} failed:\n{res['error']}")
            if rank == 0:
                out = res
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    return out


def span_cost(n: int = 2_000_000, m: int = 20_000) -> dict:
    """Host microseconds of one span: off (``n`` calls, less the bare
    loop's) and under a profiler (``m`` calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from viscoin_tpu_torch.utils import tracing

    def per_call(body, k):
        t = time.perf_counter()
        body(k)
        return (time.perf_counter() - t) / k * 1e6

    def bare(k):
        for _ in range(k):
            pass

    def spanned(k):
        for _ in range(k):
            with tracing.span("gan_step.d_forward"):
                pass

    bare_us = min(per_call(bare, n) for _ in range(3))
    off_us = min(per_call(spanned, n) for _ in range(3))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts):
        on_us = per_call(spanned, m)
    return {"span_us_off": off_us - bare_us, "bare_loop_us": bare_us, "span_us_on": on_us}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--stub", action="store_true", help="the program's spans replaced by no-ops")
    ap.add_argument("--span-cost", action="store_true", help="time one span, off and on")
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args(argv)
    if args.span_cost:
        out = span_cost()
    else:
        if args.workload is None or args.seed is None:
            ap.error("--workload and --seed are needed")
        bench = core.benchmark()
        entry = {w["name"]: w for w in bench["workloads"]}[args.workload]
        wl = core.load_json(core.workload_file(args.workload))
        config = core.load_json(core.config_file(entry["config"]))
        out = run(args.workload, wl, config, args.seed, args.seconds, args.stub,
                  world=entry["chips"])
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
