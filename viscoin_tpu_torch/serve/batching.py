"""Request micro-batching for serving, and the fixed device batch.

The batcher is a copy of ``viscoin_tpu/serve/batching.py``. It coalesces
concurrent requests into one device batch: the worker blocks for the first
request, then drains the queue for at most ``max_delay_ms`` (or until
``max_batch`` items), runs the batch function once, and resolves each
request's future with its row.

:func:`run_padded` and :func:`prepare_image` are what the live engine
(``serve/engine.py``) and a sealed artifact (``serve/export.py``) share:
the chunking of a request into padded fixed device batches, and the eval
geometry of an image of any size, and the compute dtypes. They need no
model code.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch

from viscoin_tpu_torch.data.transforms import host_test_transform
from viscoin_tpu_torch.parallel.mesh import pad_to_multiple

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def prepare_image(img_u8: np.ndarray, resolution: int) -> np.ndarray:
    """Arbitrary-size HWC u8 -> the model resolution with the eval geometry
    (Resize(short = size / 0.875) + CenterCrop)."""
    img_u8 = np.asarray(img_u8, np.uint8)
    if img_u8.shape[:2] != (resolution, resolution):
        img_u8 = host_test_transform(img_u8, size=resolution, resize_to=int(resolution / 0.875))
    return img_u8


def run_padded(call, images_u8: np.ndarray, batch_size: int) -> dict:
    """Chunk a u8 batch to ``batch_size``, pad the last chunk, drop the
    padding rows from each output and concatenate. ``call(chunk) -> dict``
    runs one fixed-size device batch and returns numpy arrays."""
    images_u8 = np.asarray(images_u8, np.uint8)
    if images_u8.ndim == 3:
        images_u8 = images_u8[None]
    n = images_u8.shape[0]
    if n == 0:
        raise ValueError("empty image batch")
    chunks: list[dict] = []
    for start in range(0, n, batch_size):
        chunk, rows = pad_to_multiple(images_u8[start: start + batch_size], batch_size)
        out = call(chunk)
        chunks.append({k: v[:rows] for k, v in out.items()})
    return {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}


@dataclass
class BatcherStats:
    """Cumulative serving statistics. All mutation and the ``snapshot`` read
    synchronize on the stats' own lock (the HTTP stats endpoint reads from
    handler threads while the worker appends)."""

    requests: int = 0
    batches: int = 0
    errors: int = 0
    rows_sum: int = 0
    latencies_ms: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=1024))
    lock: threading.Lock = field(default_factory=threading.Lock)

    def record_batch(self, n_rows: int, enq_times: list[float], errored: bool = False):
        now = time.monotonic()
        with self.lock:
            self.requests += n_rows
            self.batches += 1
            self.rows_sum += n_rows
            if errored:
                self.errors += n_rows
            for t in enq_times:
                self.latencies_ms.append((now - t) * 1000.0)

    def snapshot(self) -> dict:
        with self.lock:
            lats = sorted(self.latencies_ms)
            requests, batches = self.requests, self.batches
            errors, rows_sum = self.errors, self.rows_sum
        pct = (lambda p: lats[min(len(lats) - 1, int(p * len(lats)))] if lats else 0.0)
        return {
            "requests": requests,
            "batches": batches,
            "errors": errors,
            "mean_batch_occupancy": rows_sum / batches if batches else 0.0,
            "latency_ms_p50": round(pct(0.50), 3),
            "latency_ms_p95": round(pct(0.95), 3),
        }


class MicroBatcher:
    """Coalesce concurrent single requests into device batches.

    Args:
        run_batch: ``(list of inputs) -> sequence of outputs`` (same length
            and order). Called on the worker thread only.
        max_batch: largest batch handed to ``run_batch`` (the engine's
            device batch size).
        max_delay_ms: how long the first request of a batch may wait for
            company. 0 disables coalescing.
    """

    def __init__(self, run_batch: Callable[[list], Sequence[Any]], max_batch: int,
                 max_delay_ms: float = 5.0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._run_batch = run_batch
        self.max_batch = max_batch
        self.max_delay_s = max_delay_ms / 1000.0
        self.stats = BatcherStats()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._queue: collections.deque = collections.deque()
        self._closed = False
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="viscoin-microbatcher")
        self._worker.start()

    def submit(self, item: Any) -> Future:
        """Enqueue one request; the Future resolves to ``run_batch``'s row."""
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._queue.append((item, fut, time.monotonic()))
            self._not_empty.notify()
        return fut

    def __call__(self, item: Any) -> Any:
        """Blocking convenience: submit + wait."""
        return self.submit(item).result()

    def close(self, timeout: float = 5.0):
        with self._lock:
            self._closed = True
            self._not_empty.notify()
        self._worker.join(timeout)

    def _take_batch(self) -> list | None:
        """Block for the first item, then wait out the batching window."""
        with self._lock:
            while not self._queue and not self._closed:
                self._not_empty.wait()
            if not self._queue:
                return None  # closed and drained
            deadline = time.monotonic() + self.max_delay_s
            while len(self._queue) < self.max_batch and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._not_empty.wait(remaining)
            n = min(len(self._queue), self.max_batch)
            return [self._queue.popleft() for _ in range(n)]

    def _loop(self):
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            items = [b[0] for b in batch]
            futures = [b[1] for b in batch]
            enq_times = [b[2] for b in batch]
            try:
                outputs = self._run_batch(items)
                if len(outputs) != len(items):
                    raise RuntimeError(f"run_batch returned {len(outputs)} outputs for "
                                       f"{len(items)} inputs")
            except Exception as e:  # resolve every request with the error
                # Errored traffic still counts toward requests, batches and
                # latency, so an operator sees failures move the stats.
                self.stats.record_batch(len(items), enq_times, errored=True)
                for fut in futures:
                    if not fut.cancelled():
                        fut.set_exception(e)
                continue
            self.stats.record_batch(len(items), enq_times)
            for fut, out in zip(futures, outputs):
                if not fut.cancelled():
                    fut.set_result(out)
