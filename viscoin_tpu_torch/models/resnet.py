"""ResNet backbone + classifier f, NCHW.

Counterpart of ``viscoin_tpu/models/resnet.py`` (the HF ``microsoft/resnet-50``
architecture): 7x7/2 stem + BN + ReLU + 3x3/2 max-pool, four bottleneck
stages (depths 3/4/6/3, widths 256/512/1024/2048, stride on the 3x3 conv),
global average pooling and a linear head. ``forward`` returns
``(logits, hidden_states)`` with the 5 hidden states (stem, stage1..stage4)
in NCHW. Submodule names follow the JAX modules
(``resnet.stage{i}_block{j}.conv1.conv``...).

BatchNorm (eps 1e-5) follows flax's ``nn.BatchNorm(momentum=0.9)``, switched
by the ``train`` argument of ``forward`` as the JAX modules are (not by
``nn.Module.train()``): with ``train=False`` it applies the running
statistics; with ``train=True`` it normalizes with the batch's biased
variance, computed in fp32, and moves the running statistics towards the
batch's mean and *biased* variance, r <- 0.9 r + 0.1 v (``nn.BatchNorm2d``
would move them towards the unbiased variance).

With ``spatial`` (``parallel/spatial.py``) the image is this rank's rows of
an H-sharded batch: each plane of the shard plan ("f.stem" .. "f.stage3") is
computed on its rows (halo exchanges in the convs and the max pool, whose
halo is -inf past the edges) or whole, and the global mean is a model-group
sum. BatchNorm is then in eval mode only (elementwise).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from viscoin_tpu_torch.parallel import spatial as S
from viscoin_tpu_torch.parallel.mesh import all_mean


def lecun_normal_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Normal with variance 1 / fan_in (fan_in = product of the dims after 0)."""
    return t.normal_(0.0, 1.0 / math.sqrt(t[0].numel()), generator=generator)


BN_MOMENTUM = 0.9  # flax's: the running statistics keep 0.9 of themselves


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm + optional ReLU."""

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

    def forward(self, x: torch.Tensor, train: bool = False, mesh=None,
                sp: S.Spatial | None = None) -> torch.Tensor:
        """``sp``: ``x`` is this rank's rows of an H-sharded plane."""
        conv = self.conv
        x = S.conv2d(x, conv.weight, None, conv.stride[0], conv.padding[0], sp)
        bn = self.bn
        if train:
            x = self._batch_norm_train(x, mesh)
        else:
            mul = torch.rsqrt(bn.running_var.float() + bn.eps) * bn.weight.float()
            shift = bn.bias.float() - bn.running_mean.float() * mul
            x = x * mul.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]
        return torch.relu(x) if self.act else x

    def _batch_norm_train(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        """flax's train-mode BatchNorm: the batch's mean and biased variance
        in at least fp32, the variance as E[x²] - E[x]² clipped at 0 (flax's
        fast variance, which the gradients differentiate too), y = (x - mean)
        * rsqrt(var + eps) * scale + bias in that precision, cast back to x's
        dtype; the running statistics move towards the batch's. With a
        data-parallel ``mesh`` E[x] and E[x²] are the global batch's (one
        differentiable all-reduce of the equal ranks' means), as under the
        JAX package's GSPMD, so the running statistics agree on every rank."""
        bn = self.bn
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        moments = torch.stack([xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))])
        mean, meansq = all_mean(moments, mesh)
        var = (meansq - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            bn.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
            bn.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)
        mul = torch.rsqrt(var + bn.eps) * bn.weight.to(xf.dtype)
        y = (xf - mean[:, None, None]) * mul[:, None, None] + bn.bias.to(xf.dtype)[:, None, None]
        return y.to(x.dtype)


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

    def forward(self, x: torch.Tensor, train: bool = False, mesh=None,
                sp: S.Spatial | None = None) -> torch.Tensor:
        y = self.conv3(self.conv2(self.conv1(x, train, mesh, sp), train, mesh, sp), train,
                       mesh, sp)
        if self.shortcut is not None:
            x = self.shortcut(x, train, mesh, sp)
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

    def forward(self, x: torch.Tensor, train: bool = False, mesh=None,
                spatial: S.Spatial | None = None):
        """``spatial``: each op on its input plane's layout, its output
        moved to its own plane's (``spatial.shard_plan``); the hidden
        states in theirs."""
        sp = spatial
        x = S.convert(self.embedder(x, train, mesh, S.at(sp, "image")), sp, "image", "f.stem")
        x = S.max_pool2d(x, 3, 2, 1, S.at(sp, "f.stem"))  # pads with -inf
        x = S.convert(x, sp, "f.stem", "f.pool")
        hidden, where = [x], "f.pool"
        for i, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x, train, mesh, S.at(sp, where))
                x = S.convert(x, sp, where, f"f.stage{i}")
                where = f"f.stage{i}"
            hidden.append(x)
        return S.mean_hw(x, S.at(sp, where)), tuple(hidden)


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

    def forward(self, x: torch.Tensor, train: bool = False, mesh=None,
                spatial: S.Spatial | None = None):
        """``train``: BatchNorm on the batch's statistics, which it folds into
        the running ones (the JAX module's ``train=True``); with a
        data-parallel ``mesh``, on the global batch's. ``spatial``: ``x`` is
        this rank's rows of an H-sharded batch (eval-mode BatchNorm only);
        the logits are whole on every rank, each hidden state in its plane's
        layout (``spatial.plan["f.stage<i>"]``)."""
        if spatial is not None and train:
            raise NotImplementedError("train-mode BatchNorm on H-sharded rows is not ported")
        pooled, hidden = self.resnet(x, train, mesh, spatial)
        return self.linear(pooled), hidden
