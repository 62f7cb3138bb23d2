"""The device trace of a traced run, reduced to what the metrics read.

``torch.profiler`` records the window; :func:`reduce` keeps the device's
operations (kernels, copies, sets; not the user annotations, whose spans
would count their kernels twice) and the benchmark's own spans (the
``bench.*`` annotations of :class:`~perfbench.harness.spans.Spans`). Busy
time is the union of the operations' intervals, so kernels that overlap
(a collective beside compute) count once.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

# Where device time goes: the first class whose pattern is in a kernel's name.
KERNEL_CLASSES = (
    ("port kernels", ("bias_act", "upfirdn2d")),
    ("collectives", ("nccl",)),
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("convolutions and GEMMs", ("xmma", "gemm", "Gemm", "conv", "fft", "grad_engine",
                                "implicit", "cutlass", "winograd", "complex")),
    ("copies and casts", ("copy", "Memcpy", "Memset")),
    ("elementwise and reductions", ("elementwise", "reduce", "pool", "norm", "softmax")),
)
SPAN_PREFIX = "bench."
# The longest window a traced run records (whole step groups or cycles may
# run past it): the profiler's trace of a longer one outgrows the run's time.
TRACED_SECONDS = 8.0


def classify_kernel(name: str) -> str:
    return next((c for c, pats in KERNEL_CLASSES if any(p in name for p in pats)), "other")


@dataclass
class Trace:
    """Device operations as (start_ns, end_ns, name) and host spans as
    (start_ns, end_ns, name), on the profiler's clock; ``t0``, ``t1`` the
    traced window."""

    ops: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    t0: int = 0
    t1: int = 0

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_s(self) -> float:
        busy, end = 0, None
        for s, e, _ in self.ops:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e9

    def op_seconds(self, patterns) -> float | None:
        """Summed device time of the operations whose name holds one of
        ``patterns``; None when there is none."""
        mine = [e - s for s, e, n in self.ops if any(p in n for p in patterns)]
        return sum(mine) / 1e9 if mine else None

    def by_name(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for s, e, n in self.ops:
            out[n] = out.get(n, 0.0) + (e - s) / 1e9
        return out

    def idle_by_span(self) -> dict[str, float]:
        """Idle device time between operations, by the innermost benchmark
        span open when the gap began ("outside spans" otherwise)."""
        gaps, end = [], self.t0
        for s, e, _ in self.ops:
            if s > end:
                gaps.append((end, min(s, self.t1)))
            end = max(end, e)
        if end < self.t1:
            gaps.append((end, self.t1))
        out: dict[str, float] = {}
        spans = sorted(self.spans)
        for gs, ge in gaps:
            if ge <= gs:
                continue
            label = "outside spans"
            for s, e, n in spans:
                if s <= gs < e:
                    label = n  # later starts are inner spans
                elif s > gs:
                    break
            out[label] = out.get(label, 0.0) + (ge - gs) / 1e9
        return out

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_span().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[f"{classify_kernel(n)}: {n[:120]}", t] for n, t in ops],
                "idle_gaps": [[n, t] for n, t in gaps]}


class Window:
    """What :func:`window` leaves behind: the reduced trace, or None."""

    trace: Trace | None = None


@contextlib.contextmanager
def window(enabled: bool):
    """Around the measured window: when ``enabled``, the profiler records it
    as the span ``bench.window`` and the reduced trace is left in the
    yielded :class:`Window` once the block ends."""
    w = Window()
    if not enabled:
        yield w
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(SPAN_PREFIX + "window"):
            yield w
    span = next(e for e in prof.profiler.kineto_results.events()
                if e.name() == SPAN_PREFIX + "window")
    w.trace = reduce(prof, span.start_ns(), span.end_ns())


def reduce(prof, t0_ns: int, t1_ns: int) -> Trace:
    """The profiler's events between ``t0_ns`` and ``t1_ns`` (its clock)."""
    from torch.autograd import DeviceType

    tr = Trace(t0=t0_ns, t1=t1_ns)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                tr.ops.append((e.start_ns(), e.end_ns(), name))
        elif name.startswith(SPAN_PREFIX) and e.is_user_annotation():
            tr.spans.append((e.start_ns(), e.end_ns(), name[len(SPAN_PREFIX):]))
    tr.ops.sort()
    return tr
