"""Classifier evaluation: accuracy and mean loss over a test loader.

Counterpart of ``viscoin_tpu/eval/classifiers.py``: a ragged last batch is
padded to the loader's batch size and its padding masked out of the
metrics, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from viscoin_tpu_torch.data.loader import pad_batch
from viscoin_tpu_torch.data.transforms import device_preprocess
from viscoin_tpu_torch.eval.viscoin import to_device


@torch.no_grad()
def test_classifier(classifier, dataloader) -> tuple[float, float]:
    """(accuracy, the mean over batches of each batch's mean cross-entropy
    over its valid samples), on the device the classifier lives on, in fp32
    with the running BatchNorm statistics."""
    device = next(classifier.parameters()).device
    sums = torch.zeros(2, dtype=torch.float64, device=device)  # correct, loss
    total_samples = n_batches = 0
    for images, labels in dataloader:
        images, labels, valid = pad_batch(dataloader.batch_size, images, labels)
        n = int(valid.sum())
        x = device_preprocess(to_device(images, device))
        labels = to_device(labels.astype(np.int64), device)
        valid = to_device(valid, device)
        logits, _ = classifier(x)
        logits = logits.float()
        ce = F.cross_entropy(logits, labels, reduction="none")
        correct = ((logits.argmax(dim=1) == labels) * valid).sum()
        loss = (ce * valid).sum() / valid.sum().clamp_min(1.0)
        sums += torch.stack([correct, loss]).double()
        total_samples += n
        n_batches += 1
    correct, loss = sums.cpu().tolist()
    return correct / total_samples, loss / n_batches
