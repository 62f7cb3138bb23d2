"""Classifier evaluation: accuracy and mean loss over a test loader.

Counterpart of ``viscoin_tpu/eval/classifiers.py``: a ragged last batch is
padded to the loader's batch size and its padding masked out of the
metrics, as in the JAX package. With a data-parallel ``mesh`` each rank
passes its loader shard and every batch's sums are reduced over the ranks,
so every rank returns the global numbers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from viscoin_tpu_torch.data.loader import pad_batch
from viscoin_tpu_torch.data.transforms import device_preprocess
from viscoin_tpu_torch.eval.viscoin import to_device
from viscoin_tpu_torch.parallel.mesh import all_sum


@torch.no_grad()
def test_classifier(classifier, dataloader, mesh=None) -> tuple[float, float]:
    """(accuracy, the mean over batches of each batch's mean cross-entropy
    over its valid samples), on the device the classifier lives on, in fp32
    with the running BatchNorm statistics."""
    device = next(classifier.parameters()).device
    world = 1 if mesh is None else mesh.world
    if getattr(dataloader, "shard", (0, 1))[1] != world:
        raise ValueError(f"test loader shard world {getattr(dataloader, 'shard', (0, 1))[1]} "
                         f"!= {world}: over a mesh every rank passes its shard")
    sums = torch.zeros(3, dtype=torch.float64, device=device)  # correct, loss, valid
    n_batches = 0
    for images, labels in dataloader:
        images, labels, valid = pad_batch(dataloader.batch_size // world, images, labels)
        x = device_preprocess(to_device(images, device))
        labels = to_device(labels.astype(np.int64), device)
        valid = to_device(valid, device)
        logits, _ = classifier(x)
        logits = logits.float()
        ce = F.cross_entropy(logits, labels, reduction="none")
        # The batch's sums over every rank: correct, CE and valid count.
        correct, ce_sum, n = all_sum(torch.stack([((logits.argmax(dim=1) == labels) * valid)
                                                  .sum(), (ce * valid).sum(), valid.sum()]),
                                     mesh)
        sums += torch.stack([correct, ce_sum / n.clamp_min(1.0), n]).double()
        n_batches += 1
    correct, loss, total_samples = sums.cpu().tolist()
    return correct / total_samples, loss / n_batches
