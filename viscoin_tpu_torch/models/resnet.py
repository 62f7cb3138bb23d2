"""ResNet backbone + classifier f, NCHW.

Counterpart of ``viscoin_tpu/models/resnet.py`` (the HF ``microsoft/resnet-50``
architecture): 7x7/2 stem + BN + ReLU + 3x3/2 max-pool, four bottleneck
stages (depths 3/4/6/3, widths 256/512/1024/2048, stride on the 3x3 conv),
global average pooling and a linear head. ``forward`` returns
``(logits, hidden_states)`` with the 5 hidden states (stem, stage1..stage4)
in NCHW. BatchNorm runs in eval mode with eps 1e-5. Submodule names follow
the JAX modules (``resnet.stage{i}_block{j}.conv1.conv``...).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def lecun_normal_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Normal with variance 1 / fan_in (fan_in = product of the dims after 0)."""
    return t.normal_(0.0, 1.0 / math.sqrt(t[0].numel()), generator=generator)


class ConvBN(nn.Module):
    """Conv (no bias) + eval-mode BatchNorm + optional ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, act: bool = True, device="cuda"):
        super().__init__()
        self.act = act
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                              padding=kernel_size // 2, bias=False, device=device)
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-5, device=device)

    def init_weights(self, generator: torch.Generator):
        lecun_normal_(self.conv.weight, generator)
        self.bn.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        bn = self.bn
        mul = torch.rsqrt(bn.running_var.float() + bn.eps) * bn.weight.float()
        shift = bn.bias.float() - bn.running_mean.float() * mul
        x = x * mul.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]
        return torch.relu(x) if self.act else x


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 (stride) -> 1x1 expand, plus the shortcut."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 reduction: int = 4, device="cuda"):
        super().__init__()
        reduced = out_channels // reduction
        self.conv1 = ConvBN(in_channels, reduced, 1, 1, device=device)
        self.conv2 = ConvBN(reduced, reduced, 3, stride, device=device)
        self.conv3 = ConvBN(reduced, out_channels, 1, 1, act=False, device=device)
        self.shortcut = (ConvBN(in_channels, out_channels, 1, stride, act=False, device=device)
                         if in_channels != out_channels or stride != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv3(self.conv2(self.conv1(x)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return torch.relu(y + x)


class ResNetBackbone(nn.Module):
    """Returns pooled features (B, C) and the 5 hidden states."""

    def __init__(self, *, embedding_size: int = 64,
                 hidden_sizes: Sequence[int] = (256, 512, 1024, 2048),
                 depths: Sequence[int] = (3, 4, 6, 3), in_channels: int = 3, device="cuda"):
        super().__init__()
        self.embedder = ConvBN(in_channels, embedding_size, 7, 2, device=device)
        self.stages: list[list[str]] = []
        ch = embedding_size
        for i, (out, depth) in enumerate(zip(hidden_sizes, depths)):
            names = []
            for j in range(depth):
                stride = 2 if (i > 0 and j == 0) else 1
                self.add_module(f"stage{i}_block{j}",
                                Bottleneck(ch, out, stride, device=device))
                names.append(f"stage{i}_block{j}")
                ch = out
            self.stages.append(names)

    def forward(self, x: torch.Tensor):
        x = self.embedder(x)
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf
        hidden = [x]
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            hidden.append(x)
        return x.mean(dim=(2, 3)), tuple(hidden)


class Classifier(nn.Module):
    """ResNet classifier with a linear head; returns (logits, hidden_states)."""

    def __init__(self, *, output_classes: int = 200, embedding_size: int = 64,
                 hidden_sizes: Sequence[int] = (256, 512, 1024, 2048),
                 depths: Sequence[int] = (3, 4, 6, 3), device="cuda"):
        super().__init__()
        # The hyperparameters a checkpoint records (utils/checkpoints.py).
        self.config = dict(output_classes=output_classes, embedding_size=embedding_size,
                           hidden_sizes=tuple(hidden_sizes), depths=tuple(depths))
        self.resnet = ResNetBackbone(embedding_size=embedding_size, hidden_sizes=hidden_sizes,
                                     depths=depths, device=device)
        self.linear = nn.Linear(hidden_sizes[-1], output_classes, device=device)

    def init_weights(self, generator: torch.Generator):
        # Kaiming-normal head (variance 2 / fan_in), zero bias.
        self.linear.weight.normal_(0.0, math.sqrt(2.0 / self.linear.in_features),
                                   generator=generator)
        self.linear.bias.zero_()

    def forward(self, x: torch.Tensor):
        pooled, hidden = self.resnet(x)
        return self.linear(pooled), hidden
