"""Concept2CLIP: concept spaces to CLIP's embedding space.

Counterpart of ``viscoin_tpu/models/concept2clip.py``: a 3-layer ReLU MLP
(``fc0``, ``fc1``, ``fc2``, hidden size ``(in + out) // 2``) from the
flattened concept space (9K) or, for the StyleGAN variant, the W+ space
(num_ws * w_dim) to the CLIP embedding size. Flax ``Dense`` initialisers:
LeCun-normal weights, zero biases.
"""

from __future__ import annotations

import torch
from torch import nn

from viscoin_tpu_torch.models.resnet import lecun_normal_
from viscoin_tpu_torch.models.stylegan import flatten_concepts


class _MLP(nn.Module):
    def __init__(self, in_features: int, out_features: int, device):
        super().__init__()
        hidden = (in_features + out_features) // 2
        self.fc0 = nn.Linear(in_features, hidden, device=device)
        self.fc1 = nn.Linear(hidden, hidden, device=device)
        self.fc2 = nn.Linear(hidden, out_features, device=device)

    def init_weights(self, generator: torch.Generator):
        for fc in (self.fc0, self.fc1, self.fc2):
            lecun_normal_(fc.weight, generator)
            fc.bias.zero_()

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.fc0(x))
        x = torch.relu(self.fc1(x))
        return self.fc2(x)


class Concept2CLIP(_MLP):
    """Concept space (B, 3, 3, K) NHWC, as the JAX module and the concept
    space caches hold it, or (B, 9K) -> CLIP embeddings (B, clip_dim)."""

    def __init__(self, n_concepts: int = 256, clip_dim: int = 512, device="cuda"):
        super().__init__(n_concepts * 9, clip_dim, device)
        self.config = dict(n_concepts=n_concepts, clip_dim=clip_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 4:
            x = x.permute(0, 3, 1, 2)  # NHWC -> the (B, K, 3, 3) flatten_concepts takes
        return self.mlp(flatten_concepts(x))


class Concept2CLIPStyleGAN(_MLP):
    """W+ space (B, num_ws, w_dim) -> CLIP embeddings (B, clip_dim)."""

    def __init__(self, n_style_layers: int = 14, layer_dim: int = 512, clip_dim: int = 512,
                 device="cuda"):
        super().__init__(n_style_layers * layer_dim, clip_dim, device)
        self.config = dict(n_style_layers=n_style_layers, layer_dim=layer_dim,
                           clip_dim=clip_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x.reshape(x.shape[0], -1))
