"""Batched data loading with a background producer, and the device prefetcher.

Counterpart of ``viscoin_tpu/data/loader.py``. :class:`DataLoader` yields
fixed-shape (images uint8 (B, S, S, 3), labels int32 (B,)) numpy batches for
the on-device preprocess; a producer thread with a thread pool builds them
ahead of the consumer. The batch order is a pure function of (seed, epoch)
and each crop of (seed, epoch, index), so a resumed run replays the stream
exactly (:meth:`DataLoader.skip_batches`).

:class:`DevicePrefetcher` runs "pull the next batch and place it on the
device" on a thread of its own, some batches ahead of the training step.
Unlike the JAX package's, ``close()`` drains the queue and joins the
thread, and ``next()`` raises, rather than blocking forever, once the
prefetcher is closed or after its producer's exception was delivered.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class DataLoader:
    """Iterates (images uint8 (B, S, S, 3), labels int32 (B,)) batches.

    ``shard=(rank, world)`` yields rank's slice of every global batch
    (``batch_size`` stays the global size); the global order is the same on
    every rank, so the slices concatenate to the unsharded batch. Sharded
    loaders drop the ragged tail unless ``pad_final``, which pads the last
    batch to full size with rows labelled -1 (consumers mask on labels >= 0).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False, num_threads: int = 8, prefetch: int = 2,
                 use_native: bool | None = None, shard: tuple[int, int] = (0, 1),
                 pad_final: bool = False):
        rank, world = shard
        if world > 1 and batch_size % world != 0:
            raise ValueError(f"batch_size={batch_size} not divisible by shard world size {world}")
        if pad_final and drop_last:
            raise ValueError("pad_final and drop_last are mutually exclusive")
        self.shard = (int(rank), int(world))
        self.pad_final = pad_final
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.seed = seed
        self._epoch = 0
        self._pending_skip = 0
        # The native crop + resize, when it builds and the dataset exposes
        # its decoded images.
        if use_native is None:
            from viscoin_tpu_torch import native

            use_native = native.available() and hasattr(dataset, "raw_image")
        self.use_native = use_native

    def __len__(self) -> int:
        n = len(self.dataset)
        if not self.pad_final and (self.drop_last or self.shard[1] > 1):
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batch_indices(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng((self.seed, self._epoch)).shuffle(idx)
        rank, world = self.shard
        if self.pad_final and n % self.batch_size:
            idx = np.concatenate([idx, np.full((-n) % self.batch_size, -1, np.int64)])
            n = idx.shape[0]
        drop = self.drop_last or world > 1
        end = (n // self.batch_size) * self.batch_size if drop else n
        per = self.batch_size // world
        for start in range(0, end, self.batch_size):
            b = idx[start: start + self.batch_size]
            yield b[rank * per: (rank + 1) * per] if world > 1 else b

    def skip_batches(self, k: int) -> None:
        """Fast-forward k batches without building them: whole epochs advance
        the epoch counter, the rest is dropped from the next ``__iter__``."""
        per_epoch = len(self)
        self._epoch += k // per_epoch
        self._pending_skip = k % per_epoch

    def _make_batch(self, indices, pool: ThreadPoolExecutor | None):
        indices = np.asarray(indices)
        pad_mask = indices < 0  # pad_final sentinel rows
        if pad_mask.any():
            # Row 0 as a placeholder, masked by its label -1: every rank pads
            # alike, so sharded slices concatenate to the unsharded batch.
            images, labels = self._make_batch(np.where(pad_mask, 0, indices), pool)
            labels = labels.copy()
            labels[pad_mask] = -1
            return images, labels
        if self.use_native:
            return self._make_batch_native(indices, pool)
        items = list(pool.map(self.dataset.__getitem__, indices)) if pool is not None \
            else [self.dataset[i] for i in indices]
        return (np.stack([it[0] for it in items]),
                np.asarray([it[1] for it in items], np.int32))

    def _make_batch_native(self, indices, pool: ThreadPoolExecutor | None):
        """Decode (threaded, cached), then one native crop + resize call."""
        from viscoin_tpu_torch import native

        ds = self.dataset
        raws = list(pool.map(ds.raw_image, indices)) if pool is not None \
            else [ds.raw_image(i) for i in indices]
        raws = [np.ascontiguousarray(r) for r in raws]
        # Crop geometry keyed by (seed, epoch, index) per image: a sharded
        # slice reproduces the crops of the unsharded batch.
        rngs = [np.random.default_rng((self.seed, self._epoch, int(i))) for i in indices]
        boxes = native.crop_boxes([r.shape[:2] for r in raws], ds.transform_mode, ds.out_size,
                                  rngs)
        images = native.transform_batch(raws, boxes, ds.out_size,
                                        n_threads=max(self.num_threads, 1))
        return images, np.asarray([ds._label(int(i)) for i in indices], np.int32)

    def __iter__(self):
        self._epoch += 1
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self._epoch)
        batches = list(self._batch_indices())
        if self._pending_skip:
            batches = batches[self._pending_skip:]
            self._pending_skip = 0
        if self.num_threads <= 0:
            for b in batches:
                yield self._make_batch(b, None)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # Re-checks stop: a consumer that abandons the iterator must not
            # leave this thread blocked on a full queue.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for b in batches:
                        if stop.is_set() or not put(self._make_batch(b, pool)):
                            return
            except BaseException as e:  # noqa: BLE001 - forwarded to the consumer
                put(e)
                return
            put(None)

        t = threading.Thread(target=producer, daemon=True, name="loader-producer")
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()


class PrefetcherClosed(RuntimeError):
    """``next()`` on a closed or failed :class:`DevicePrefetcher`."""


class DevicePrefetcher:
    """Run ``produce_fn`` (pull the next batch and place it on the device) on
    a background thread, up to ``depth`` results ahead of the consumer.

    One producer and one FIFO queue: the order is the synchronous order, so
    determinism and resume are unchanged. An exception of ``produce_fn``
    reaches the consumer's next ``next()``; after it, ``next()`` raises
    :class:`PrefetcherClosed`. ``close()`` is idempotent, drains the queue and
    joins the thread; callers run it in a ``finally``."""

    _POLL_S = 0.05

    def __init__(self, produce_fn, depth: int = 1):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._closed = False
        self._failed = False

        def run():
            try:
                while not self._stop.is_set():
                    if not self._put(produce_fn()):
                        return
            except BaseException as e:  # noqa: BLE001 - forwarded to the consumer
                self._put(e)

        self._thread = threading.Thread(target=run, daemon=True, name="device-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=self._POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def next(self):
        if self._closed:
            raise PrefetcherClosed("next() on a closed DevicePrefetcher")
        if self._failed:
            raise PrefetcherClosed("the DevicePrefetcher's producer failed; its exception "
                                   "was raised by an earlier next()")
        while True:
            try:
                item = self._q.get(timeout=self._POLL_S)
                break
            except queue.Empty:
                if self._closed:
                    raise PrefetcherClosed("next() on a closed DevicePrefetcher") from None
                if not self._thread.is_alive() and self._q.empty():
                    self._failed = True
                    raise PrefetcherClosed("the DevicePrefetcher's producer stopped") from None
        if isinstance(item, BaseException):
            self._failed = True
            raise item
        return item

    def close(self) -> None:
        """Stop the producer, drop what it made and join its thread."""
        self._closed = True
        self._stop.set()
        while self._thread.is_alive():
            self._drain()
            self._thread.join(self._POLL_S)
        self._drain()

    def _drain(self) -> None:
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return


def loop_iter(loader):
    """Cycle over the loader forever."""
    while True:
        yield from loader


def pad_batch(batch_size: int, images, labels=None):
    """Pad a ragged batch up to ``batch_size`` by repeating its first row and
    return the float validity mask: short batches mask by row count,
    ``pad_final`` batches by their label -1 (clamped back to 0).

    Returns ``(images, valid)`` or ``(images, labels, valid)``."""
    images = np.asarray(images)
    n = images.shape[0]
    if n < batch_size:
        pad = batch_size - n
        images = np.concatenate([images, np.repeat(images[:1], pad, axis=0)])
        if labels is not None:
            labels = np.concatenate([np.asarray(labels), np.repeat(np.asarray(labels)[:1], pad)])
    valid = (np.arange(batch_size) < n).astype(np.float32)
    if labels is None:
        return images, valid
    labels = np.asarray(labels)
    valid = valid * (labels >= 0)
    return images, np.maximum(labels, 0), valid
