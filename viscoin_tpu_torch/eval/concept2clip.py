"""Concept2CLIP evaluation.

Counterpart of ``viscoin_tpu/eval/concept2clip.py``. As in the reference,
shuffle the test loader: cosine matching over batches of birds of one class
gives misleading scores.

The pipeline runs in one process on one device: it precomputes the
whole-dataset latent spaces on one process (``eval/spaces.py``'s disk
caches), as the JAX package does, which refuses several processes. JAX's
local mesh splits each batch over the devices of that process; its results
equal the one-device path's up to reduction order, which is what this
process computes.
"""

from __future__ import annotations

import numpy as np
import torch

from viscoin_tpu_torch.utils.metrics import cosine_matching


def check_one_process(world: int) -> None:
    """Raise for a group of several processes, with the JAX package's reason."""
    if world > 1:
        raise ValueError(
            "the concept2clip pipeline precomputes whole-dataset latent spaces on one process "
            "(eval/spaces.py disk caches) — run it single-process (it is minutes of work); "
            f"a group of {world} processes is not supported here")


def _check_mesh(mesh) -> None:
    """Counterpart of the JAX package's ``_check_mesh``: a data-parallel
    mesh of several processes is refused; None (one process) passes."""
    if mesh is not None:
        check_one_process(mesh.world)


@torch.no_grad()
def test_concept2clip(concept2clip, loader, mesh=None):
    """(mean per-batch MSE / batch_size, mean cosine-matching accuracy) over
    ``loader`` ((spaces, embeddings) numpy batches); the reference divides
    the per-batch MSE by the batch size."""
    _check_mesh(mesh)
    device = next(concept2clip.parameters()).device
    batch_size = loader.batch_size
    loss = 0.0
    matching = 0.0
    n = 0
    for spaces, embeddings in loader:
        out = concept2clip(torch.from_numpy(np.ascontiguousarray(spaces)).to(device))
        emb = torch.from_numpy(np.ascontiguousarray(embeddings)).to(device)
        loss += float(torch.mean(torch.square(out - emb))) / batch_size
        matching += cosine_matching(out, emb)
        n += 1
    return loss / n, matching / n


class TensorLoader:
    """(x, y) batches of two arrays of one length: the order reshuffled per
    iteration from ``np.random.default_rng(seed)`` (one stream over the
    iterations), the last batch ragged."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int,
                 shuffle: bool = True, seed: int = 0):
        if len(x) != len(y):
            raise ValueError(f"x has {len(x)} rows, y {len(y)}")
        self.x, self.y = x, y
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return -(-len(self.x) // self.batch_size)

    def __iter__(self):
        idx = np.arange(len(self.x))
        if self.shuffle:
            self._rng.shuffle(idx)
        for s in range(0, len(idx), self.batch_size):
            sel = idx[s: s + self.batch_size]
            yield self.x[sel], self.y[sel]
