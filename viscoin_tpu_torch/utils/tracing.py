"""Named spans of the training steps, on the profiler's clock.

``span(name)`` is ``torch.profiler.record_function("vt." + name)`` while a
``torch.profiler`` records (an operator's ``--profile-dir``, or any profiler
a caller runs around the steps), and one shared no-op context otherwise: a
single flag read, nothing allocated. There is no setting: a span records
exactly when a profiler runs. A span never synchronises the card, never
reads a tensor and never changes what a step computes; the device work
launched inside it is attributed to it by the profiler's launch events.

Names are dotted paths, a child carrying its parent's name:
``viscoin_step.backward`` inside ``viscoin_step``.

The counter of how the VisCoIN steps ran (:func:`graph_counts`): "captures"
(the step captured its CUDA graph, then replayed it), "replays" (every step
that ran as a replay, the capturing one included) and "eager", each eager
step also under "eager.<reason>" (``train/viscoin.py::eager_reason``, or
"capture_failed"). Inside a replay no span of the captured region records:
``viscoin_step.replay`` stands for all of them.

The counter of the StyleGAN2 blocks' precision (:func:`precision_counts`):
every G and D block call by the dtype it ran in, "blocks.fp16",
"blocks.bf16" or "blocks.fp32", and under "blocks.<dtype>.<net><res>"
(``g128``: G's 128² block, ``d1024``: D's block on 1024² inputs), counted
on the host; and "grad_nonfinite", the gradient elements the fp16
networks' sanitizer replaced (``train/gan.py``), summed on the device and
read only when the counter is read. The blocks that run in float16 are
the span ``g_fp16`` or ``d_fp16`` (:func:`fp16_region`), in the forward
and, while a profiler records, in the backward too.
"""

from __future__ import annotations

import contextlib
import time
from collections import Counter

import torch
import torch.autograd.profiler as _profiler

PREFIX = "vt."
_OFF = contextlib.nullcontext()
_GRAPH_COUNTS: Counter = Counter()
_PRECISION_COUNTS: Counter = Counter()
_NONFINITE: dict = {}  # device -> 0-d int64 tensor: the sanitizer's replaced elements
DTYPE_NAMES = {torch.float32: "fp32", torch.bfloat16: "bf16", torch.float16: "fp16"}
_BLOCK_KEYS: dict = {}


def span(name: str):
    """The span ``vt.<name>`` while a profiler records; a shared no-op
    context otherwise."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(PREFIX + name)
    return _OFF


@contextlib.contextmanager
def timed(name: str | None, timings: dict | None, key: str):
    """``span(name)`` (none for ``name`` None) whose host seconds, when
    ``timings`` is a dict, are added to it under ``key``: the total, the
    count ``n_<key>``, the largest ``max_<key>`` and every duration under
    ``timings["seconds"][key]``. Nothing synchronises, so the seconds are
    the host's: for work on the card, the time to enqueue it."""
    t0 = time.perf_counter()
    with span(name) if name is not None else _OFF:
        yield
    if timings is not None:
        dt = time.perf_counter() - t0
        timings[key] = timings.get(key, 0.0) + dt
        timings[f"n_{key}"] = timings.get(f"n_{key}", 0) + 1
        timings[f"max_{key}"] = max(timings.get(f"max_{key}", 0.0), dt)
        timings.setdefault("seconds", {}).setdefault(key, []).append(dt)


def count_graph(kind: str, reason: str | None = None) -> None:
    """Count one step as ``kind`` ("captures", "replays" or "eager"), and
    under "<kind>.<reason>" when a ``reason`` is given."""
    _GRAPH_COUNTS[kind] += 1
    if reason is not None:
        _GRAPH_COUNTS[f"{kind}.{reason}"] += 1


def graph_counts() -> Counter:
    """The counted steps since :func:`reset_graph_counts`, by kind and reason."""
    return Counter(_GRAPH_COUNTS)


def reset_graph_counts() -> None:
    _GRAPH_COUNTS.clear()


def count_block(block: str, dtype: torch.dtype) -> None:
    """Count one call of the G or D block ``block`` ("g128", "d1024") that
    ran in ``dtype``."""
    keys = _BLOCK_KEYS.get((block, dtype))
    if keys is None:
        name = DTYPE_NAMES.get(dtype, str(dtype).removeprefix("torch."))
        keys = _BLOCK_KEYS[(block, dtype)] = (f"blocks.{name}", f"blocks.{name}.{block}")
    _PRECISION_COUNTS[keys[0]] += 1
    _PRECISION_COUNTS[keys[1]] += 1


def count_nonfinite(n: torch.Tensor) -> None:
    """Add ``n`` (a 0-d device tensor) to "grad_nonfinite" on its device,
    without reading it."""
    acc = _NONFINITE.get(n.device)
    _NONFINITE[n.device] = n if acc is None else acc + n


def precision_counts() -> Counter:
    """The block calls by dtype and the replaced gradient elements since
    :func:`reset_precision_counts` (reading the latter waits for the card)."""
    out = Counter(_PRECISION_COUNTS)
    if _NONFINITE:
        out["grad_nonfinite"] = sum(int(t) for t in _NONFINITE.values())
    return out


def reset_precision_counts() -> None:
    _PRECISION_COUNTS.clear()
    _NONFINITE.clear()


class _Open:
    """The backward's span of a region, opened by :class:`_RegionEnd`'s
    backward and closed by :class:`_RegionStart`'s."""

    def __init__(self, name: str):
        self.name, self.rf = name, None


class _RegionStart(torch.autograd.Function):
    @staticmethod
    def forward(ctx, state, *xs):
        ctx.state = state
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.state.rf is not None:
            ctx.state.rf.__exit__(None, None, None)
            ctx.state.rf = None
        return (None, *grads)


class _RegionEnd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, state, *xs):
        ctx.state = state
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.state.rf is None:
            ctx.state.rf = torch.profiler.record_function(PREFIX + ctx.state.name + ".backward")
            ctx.state.rf.__enter__()
        return (None, *grads)


class fp16_region:
    """The span ``name`` around a block that runs in float16. While a
    profiler records, :meth:`enter` and :meth:`exit` also mark the block's
    inputs and outputs, so that the backward of what it computed runs in
    the span ``<name>.backward`` (opened when the gradient reaches the
    block's outputs, closed when it has reached its inputs; a block none of
    whose inputs takes a gradient, D's first on an image that needs none,
    is not marked, having no point at which its backward ends); otherwise
    both give their tensors back as they are."""

    def __init__(self, name: str):
        self.name = name
        self.on = _profiler._is_profiler_enabled
        self.state = _Open(name) if self.on else None
        self.started = False
        self.span = span(name)

    def __enter__(self):
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        return self.span.__exit__(*exc)

    def _mark(self, fn, xs):
        if not self.on:
            return xs
        live = [i for i, x in enumerate(xs) if x is not None and x.requires_grad]
        if not live:
            return xs
        out = list(xs)
        for i, y in zip(live, fn.apply(self.state, *(xs[i] for i in live))):
            out[i] = y
        return tuple(out)

    def enter(self, *xs):
        out = self._mark(_RegionStart, xs)
        self.started = out is not xs
        return out

    def exit(self, *xs):
        return self._mark(_RegionEnd, xs) if self.started else xs
