"""The benchmark's own spans around the calls into each layer.

In a traced run a span synchronises the card at its start and end (so its
host time is the work's) and is recorded as a ``bench.<name>`` annotation in
the device trace, where the idle gaps are labelled by it. In an untimed
run it only adds its host duration, and never synchronises.
"""

from __future__ import annotations

import contextlib
import time

import torch


class Spans:
    def __init__(self, traced: bool, sync=None):
        self.traced = traced
        self._sync = sync or (torch.cuda.synchronize if torch.cuda.is_available()
                              else (lambda: None))
        self.seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.traced:
            self._sync()
        ctx = (torch.profiler.record_function(f"bench.{name}") if self.traced
               else contextlib.nullcontext())
        t = time.perf_counter()
        with ctx:
            yield
            if self.traced:
                self._sync()
        dt = time.perf_counter() - t
        self.seconds[name] = self.seconds.get(name, 0.0) + dt
