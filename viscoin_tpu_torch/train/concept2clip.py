"""Concept2CLIP training.

Counterpart of ``viscoin_tpu/train/concept2clip.py``: a 30-epoch MSE
regression (Adam, learning rate 1e-5, batch 32) from precomputed concept or
W+ spaces (``eval/spaces.py``) to precomputed CLIP image embeddings
(``models/clip.py``). Training batches follow
``np.random.default_rng(seed).permutation(n)`` per epoch, the last partial
batch dropped; the test loader is shuffled on purpose (seed + 1), as in the
reference. The best parameters are chosen by test loss.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np
import torch

from viscoin_tpu_torch.eval.concept2clip import TensorLoader, _check_mesh, test_concept2clip
from viscoin_tpu_torch.utils.dataclasses import IgnoreNone
from viscoin_tpu_torch.utils.logging import get_logger
from viscoin_tpu_torch.utils.weights import module_to_jax_tree


@dataclass
class Concept2ClipTrainingParams(IgnoreNone):
    epochs: int = 30
    learning_rate: float = 1e-5
    batch_size: int = 32


def train_concept2clip(concept2clip, train_spaces: np.ndarray, train_embeddings: np.ndarray,
                       test_spaces: np.ndarray, test_embeddings: np.ndarray,
                       params: Concept2ClipTrainingParams, seed: int = 0, mesh=None):
    """Train ``concept2clip`` (its weights are the initial ones) in place;
    returns (the best test loss's parameters in the JAX package's layout,
    as numpy arrays; that loss). One log record per epoch:
    ``train_loss``, ``test_loss``, ``matching_accuracy``."""
    _check_mesh(mesh)
    logger = get_logger()
    device = next(concept2clip.parameters()).device
    weights = list(concept2clip.parameters())
    for p in weights:
        p.requires_grad_(True)
    # optax.adam's update: b1 0.9, b2 0.999, eps added to the bias-corrected root.
    opt = torch.optim.Adam(weights, lr=params.learning_rate, betas=(0.9, 0.999), eps=1e-8)
    bs = params.batch_size
    rng = np.random.default_rng(seed)
    n = len(train_spaces)
    best_loss = float("inf")
    best_params = module_to_jax_tree(concept2clip)["params"]
    test_loader = TensorLoader(test_spaces, test_embeddings, bs, shuffle=True, seed=seed + 1)

    def to_device(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    for _ in range(params.epochs):
        idx = rng.permutation(n)
        train_loss = 0.0
        n_batches = 0
        for s in range(0, n - bs + 1, bs):
            sel = idx[s: s + bs]
            out = concept2clip(to_device(train_spaces[sel]))
            loss = torch.mean(torch.square(out - to_device(train_embeddings[sel])))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            # The reference divides the per-batch loss by the batch size.
            train_loss += float(loss.detach()) / bs
            n_batches += 1
        train_loss /= max(n_batches, 1)

        test_loss, matching_accuracy = test_concept2clip(concept2clip, test_loader)
        if test_loss < best_loss:
            best_loss = test_loss
            best_params = module_to_jax_tree(concept2clip)["params"]
        logger.info(json.dumps({"train_loss": train_loss, "test_loss": test_loss,
                                "matching_accuracy": matching_accuracy}))

    print(f"Best test loss: {best_loss:.4f}")
    return best_params, best_loss
