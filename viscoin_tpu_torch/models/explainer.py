"""Explainer Theta: class prediction from the concept space.

Counterpart of ``viscoin_tpu/models/explainer.py``: the reference's
Dropout(0.01) on the concept maps (training only), max-pool each 3x3
concept map to a scalar, then a linear layer to the classes, optionally
weight-normalized as ``w = g * v / (||v|| + 1e-12)`` per output row (the JAX
package adds the 1e-12; torch's ``weight_norm`` does not).

The dropout draws its keep mask from an explicit ``torch.Generator``, or
takes the mask itself (``dropout_mask``, True where kept), so a test can
replay the mask the JAX side drew. Kept values are scaled by 1 / 0.99, as
flax's ``nn.Dropout`` does.
"""

from __future__ import annotations

import torch
from torch import nn

from viscoin_tpu_torch.models.concept_extractor import max_pool_concepts
from viscoin_tpu_torch.models.resnet import lecun_normal_

DROPOUT_RATE = 0.01


class Explainer(nn.Module):
    def __init__(self, *, n_concepts: int = 256, n_classes: int = 200,
                 normalized: bool = False, device="cuda"):
        super().__init__()
        self.config = dict(n_concepts=n_concepts, n_classes=n_classes, normalized=normalized)
        self.normalized = normalized
        if normalized:
            self.weight_v = nn.Parameter(torch.empty(n_classes, n_concepts, device=device))
            self.weight_g = nn.Parameter(torch.empty(n_classes, 1, device=device))
            self.bias = nn.Parameter(torch.empty(n_classes, device=device))
        else:
            self.linear = nn.Linear(n_concepts, n_classes, device=device)

    def init_weights(self, generator: torch.Generator):
        if self.normalized:
            lecun_normal_(self.weight_v, generator)
            self.weight_g.fill_(1.0)
            self.bias.zero_()
        else:
            lecun_normal_(self.linear.weight, generator)
            self.linear.bias.zero_()

    def effective_weight(self) -> torch.Tensor:
        """The (n_classes, n_concepts) weight, resolving the weight norm."""
        if not self.normalized:
            return self.linear.weight
        v = self.weight_v
        return self.weight_g * v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + 1e-12)

    def forward(self, phi: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                dropout_mask: torch.Tensor | None = None) -> torch.Tensor:
        """phi: (B, K, 3, 3) concept maps -> (B, n_classes) logits. With
        ``train``, dropout with ``dropout_mask`` (bool, phi's shape) or a mask
        drawn from ``generator``."""
        if train:
            keep = 1.0 - DROPOUT_RATE
            if dropout_mask is None:
                dropout_mask = torch.rand(phi.shape, generator=generator,
                                          device=phi.device) < keep
            phi = torch.where(dropout_mask, phi / keep, torch.zeros((), dtype=phi.dtype,
                                                                     device=phi.device))
        x = max_pool_concepts(phi)
        if self.normalized:
            return x @ self.effective_weight().T + self.bias
        return self.linear(x)
