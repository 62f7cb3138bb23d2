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
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.autograd.profiler as _profiler

PREFIX = "vt."
_OFF = contextlib.nullcontext()


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
