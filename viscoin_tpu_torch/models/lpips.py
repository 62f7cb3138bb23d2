"""LPIPS perceptual distance on a VGG16 backbone, NCHW.

Counterpart of ``viscoin_tpu/models/lpips.py`` on its standard path (the
``paired_block1`` and ``fold_block12`` variants are TPU layout tricks and are
not ported): the VGG16 feature stack sliced at relu1_2 / 2_2 / 3_3 / 4_3 /
5_3, LPIPS v0.1's fixed shift and scale, channel-unit-normalised feature
differences weighted by the learned ``lin{i}`` heads, a spatial mean, summed
over the five slices. The distance uses the JAX package's one-pass form

    sum_c lin_c (a_c / Na - b_c / Nb)^2 = La / Na^2 + Lb / Nb^2 - 2 Lab / (Na Nb),
    Na = ||a|| + 1e-10,  La = sum lin a^2,  Lab = sum lin a b,

with the channel sums in fp32. The two towers run separately, so the target
branch (no gradient) records no graph. Weights start random from a seed
(``init_weights``) or come from the JAX package's params through
``utils/weights.py::load_jax_tree``.

With ``spatial`` (``parallel/spatial.py``) the images are this rank's rows
of an H-sharded batch: each slice runs in its plane's layout of the shard
plan ("lpips.0".."lpips.4"), and the spatial means of the sharded slices are
one model-group sum, so the distances are whole on every rank.
"""

from __future__ import annotations

import torch
from torch import nn

from viscoin_tpu_torch.data.transforms import channel_constant
from viscoin_tpu_torch.models.resnet import lecun_normal_
from viscoin_tpu_torch.parallel import spatial as S

SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
# VGG16 'D' grouped into the 5 LPIPS slices (channels per conv).
SLICES = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))
LPIPS_CHANNELS = tuple(s[-1] for s in SLICES)


class VGG16Features(nn.Module):
    """The 13 3x3 convs ``conv0`` .. ``conv12`` with ReLU, a 2x2 max-pool
    before every slice but the first; returns the 5 slice outputs."""

    def __init__(self, in_channels: int = 3, device="cuda"):
        super().__init__()
        idx, ch = 0, in_channels
        for channels in SLICES:
            for out in channels:
                self.add_module(f"conv{idx}", nn.Conv2d(ch, out, 3, padding=1, device=device))
                idx, ch = idx + 1, out

    def init_weights(self, generator: torch.Generator):
        for conv in self.children():
            lecun_normal_(conv.weight, generator)
            conv.bias.zero_()

    def forward(self, x: torch.Tensor, spatial: S.Spatial | None = None
                ) -> tuple[torch.Tensor, ...]:
        """``spatial``: ``x`` is this rank's rows; each slice output comes
        in its plane's layout."""
        outs, idx = [], 0
        for slice_idx, channels in enumerate(SLICES):
            plane = f"lpips.{slice_idx}"
            if slice_idx > 0:  # on the previous slice's layout, then on this one's
                prev = f"lpips.{slice_idx - 1}"
                x = S.convert(S.max_pool2d(x, 2, 2, 0, S.at(spatial, prev)), spatial, prev,
                              plane)
            for _ in channels:
                conv = getattr(self, f"conv{idx}")
                x = torch.relu(S.conv2d(x, conv.weight, conv.bias, 1, 1, S.at(spatial, plane)))
                idx += 1
            outs.append(x)
        return tuple(outs)


class LPIPS(nn.Module):
    """``forward(x, y)`` -> (B,) perceptual distances between NCHW batches."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.vgg = VGG16Features(device=device)
        for i, c in enumerate(LPIPS_CHANNELS):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.empty(c, device=device)))

    def init_weights(self, generator: torch.Generator):
        for i in range(len(LPIPS_CHANNELS)):
            getattr(self, f"lin{i}").uniform_(0.0, 1.0, generator=generator)  # non-negative

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                spatial: S.Spatial | None = None) -> torch.Tensor:
        """``spatial``: ``x`` and ``y`` are this rank's rows of H-sharded
        batches; the (B,) distances are whole on every rank."""
        shift, scale = channel_constant(SHIFT, x), channel_constant(SCALE, x)
        fx = self.vgg((x - shift) / scale, spatial)
        fy = self.vgg((y - shift) / scale, spatial)
        total = 0.0
        sharded = 0.0  # the sharded slices' local sums over the global count
        f32 = torch.float32
        for i, (a, b) in enumerate(zip(fx, fy)):
            lin = getattr(self, f"lin{i}").to(a.dtype)[:, None, None]
            sa = torch.sum(a.square(), dim=1, dtype=f32)
            sb = torch.sum(b.square(), dim=1, dtype=f32)
            la = torch.sum(lin * a.square(), dim=1, dtype=f32)
            lb = torch.sum(lin * b.square(), dim=1, dtype=f32)
            lab = torch.sum(lin * a * b, dim=1, dtype=f32)
            na = sa.sqrt() + 1e-10
            nb = sb.sqrt() + 1e-10
            dist = la / na.square() + lb / nb.square() - 2.0 * lab / (na * nb)
            if S.sharded(spatial, f"lpips.{i}"):
                sharded = sharded + dist.sum(dim=(1, 2)) / (dist.shape[1] * spatial.model
                                                            * dist.shape[2])
            else:
                total = total + dist.mean(dim=(1, 2))
        if spatial is not None:
            total = total + S.model_sum(sharded, spatial)
        return total

    def normalized_difference(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The same distance in LPIPS's own form, sum_c lin_c (a_c / Na -
        b_c / Nb)^2, in the inputs' dtype. For nearly equal inputs (PPL's
        pairs, epsilon = 1e-4 apart) the one-pass form's three fp32 sums
        cancel to rounding; this form keeps the difference."""
        shift, scale = channel_constant(SHIFT, x), channel_constant(SCALE, x)
        total = 0.0
        for i, (a, b) in enumerate(zip(self.vgg((x - shift) / scale),
                                       self.vgg((y - shift) / scale))):
            a = a / (a.square().sum(dim=1, keepdim=True).sqrt() + 1e-10)
            b = b / (b.square().sum(dim=1, keepdim=True).sqrt() + 1e-10)
            lin = getattr(self, f"lin{i}").to(a.dtype)[:, None, None]
            total = total + (lin * (a - b).square()).sum(dim=1).mean(dim=(1, 2))
        return total
