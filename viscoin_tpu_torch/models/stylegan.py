"""StyleGAN2 synthesis and VisCoIN's adapted generator, NCHW / OIHW.

Counterpart of ``viscoin_tpu/models/stylegan.py``, restricted to what
VisCoIN's training step needs: the equalized-LR :class:`FullyConnected`,
:class:`SynthesisLayer`, :class:`ToRGBLayer`, :class:`SynthesisBlock` (skip
architecture), :class:`SynthesisNetwork`, :class:`MappingNetworkAdapted`
(the per-style-layer MLPs stacked into two groups) and
:class:`GeneratorAdapted`; the original :class:`MappingNetwork` and
:class:`Generator` (the frozen source of synthetic training images); and
:func:`adapted_state_from_gan`. ``Conv2dLayer`` and the discriminator belong
to the GAN trainer and are not ported yet. Parameter names and shapes follow
the JAX modules, with conv weights in OIHW and the 4x4 constant in CHW, so
``utils/weights.py`` carries the JAX variables across by name.

``noise_mode`` is "random" (drawn from the ``generator`` argument, a
``torch.Generator`` on the activations' device), "const" (the ``noise_const``
buffers) or "none".
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from viscoin_tpu_torch.ops import bias_act, modulated_conv2d, setup_filter, upsample2d
from viscoin_tpu_torch.ops.bias_act import activation_funcs

RESAMPLE_FILTER = (1.0, 3.0, 3.0, 1.0)


def num_ws_for_resolution(img_resolution: int) -> int:
    """Style vectors of a skip synthesis pyramid: 1 conv at 4², 2 per higher
    block, +1 for the last toRGB (14 at 256²)."""
    return 2 * int(math.log2(img_resolution)) - 2


def normalize_2nd_moment(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


def flatten_concepts(phi: torch.Tensor) -> torch.Tensor:
    """(B, K, 3, 3) concept maps -> (B, 9K) in the reference's concept-major
    order, which for NCHW is the natural flatten."""
    if phi.ndim == 2:
        return phi
    return phi.reshape(phi.shape[0], -1)


class FullyConnected(nn.Module):
    """Equalized-LR fully connected layer; ``weight`` is stored (out, in)."""

    def __init__(self, in_features: int, out_features: int, *, use_bias: bool = True,
                 activation: str = "linear", lr_multiplier: float = 1.0,
                 bias_init: float = 0.0, device="cuda"):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.bias_init = bias_init
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, device=device))
                     if use_bias else None)

    def init_weights(self, generator: torch.Generator):
        self.weight.normal_(0.0, 1.0 / self.lr_multiplier, generator=generator)
        if self.bias is not None:
            self.bias.fill_(self.bias_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype) * (self.lr_multiplier / math.sqrt(self.in_features))
        b = self.bias
        if b is not None and self.lr_multiplier != 1.0:
            b = b * self.lr_multiplier
        return bias_act(x @ w.T, b, act=self.activation)


class SynthesisLayer(nn.Module):
    """Modulated conv + noise + bias + lrelu."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int, *,
                 kernel_size: int = 3, up: int = 1, use_noise: bool = True,
                 activation: str = "lrelu", resample_filter=RESAMPLE_FILTER,
                 conv_clamp: float | None = None, device="cuda"):
        super().__init__()
        self.resolution, self.up, self.use_noise = resolution, up, use_noise
        self.activation, self.conv_clamp = activation, conv_clamp
        self.padding = kernel_size // 2
        self.resample_filter = setup_filter(list(resample_filter)) if up > 1 else None
        self.affine = FullyConnected(w_dim, in_channels, bias_init=1.0, device=device)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size,
                                               kernel_size, device=device))
        if use_noise:
            self.noise_strength = nn.Parameter(torch.empty((), device=device))
            self.register_buffer("noise_const",
                                 torch.empty(resolution, resolution, device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device))

    def init_weights(self, generator: torch.Generator):
        self.weight.normal_(generator=generator)
        self.bias.zero_()
        if self.use_noise:
            self.noise_strength.zero_()
            self.noise_const.normal_(generator=generator)

    def forward(self, x: torch.Tensor, w: torch.Tensor, noise_mode: str = "random",
                gain: float = 1.0, generator: torch.Generator | None = None) -> torch.Tensor:
        if noise_mode not in ("random", "const", "none"):
            raise ValueError(f"noise_mode must be random, const or none: {noise_mode!r}")
        styles = self.affine(w.float())
        noise = None
        if self.use_noise and noise_mode == "random":
            noise = torch.randn((x.shape[0], 1, self.resolution, self.resolution),
                                generator=generator, device=x.device) * self.noise_strength
        elif self.use_noise and noise_mode == "const":
            noise = self.noise_const[None, None] * self.noise_strength
        x = modulated_conv2d(x, self.weight, styles, noise=noise, up=self.up,
                             padding=self.padding, resample_filter=self.resample_filter,
                             flip_weight=(self.up == 1))
        act_gain = activation_funcs[self.activation].def_gain * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, act=self.activation, gain=act_gain, clamp=act_clamp)


class ToRGBLayer(nn.Module):
    """Modulated conv to image channels, no demodulation."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, *,
                 kernel_size: int = 1, conv_clamp: float | None = None, device="cuda"):
        super().__init__()
        self.conv_clamp = conv_clamp
        self.padding = kernel_size // 2
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size * kernel_size)
        self.affine = FullyConnected(w_dim, in_channels, bias_init=1.0, device=device)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size,
                                               kernel_size, device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device))

    def init_weights(self, generator: torch.Generator):
        self.weight.normal_(generator=generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        styles = self.affine(w.float())
        x = modulated_conv2d(x, self.weight, styles * self.weight_gain, demodulate=False,
                             padding=self.padding)
        return bias_act(x, self.bias, act="linear", clamp=self.conv_clamp)


class SynthesisBlock(nn.Module):
    """One resolution of the skip architecture: (conv0, up 2), conv1, toRGB,
    and the upsampled running image."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int,
                 img_channels: int, *, resample_filter=RESAMPLE_FILTER,
                 conv_clamp: float | None = None, device="cuda"):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.resample_filter = setup_filter(list(resample_filter))
        if in_channels == 0:
            self.const = nn.Parameter(torch.empty(out_channels, 4, 4, device=device))
        else:
            self.conv0 = SynthesisLayer(in_channels, out_channels, w_dim, resolution, up=2,
                                        resample_filter=resample_filter,
                                        conv_clamp=conv_clamp, device=device)
        self.conv1 = SynthesisLayer(out_channels, out_channels, w_dim, resolution,
                                    resample_filter=resample_filter, conv_clamp=conv_clamp,
                                    device=device)
        self.torgb = ToRGBLayer(out_channels, img_channels, w_dim, conv_clamp=conv_clamp,
                                device=device)

    @property
    def num_conv(self) -> int:
        return 1 if self.in_channels == 0 else 2

    def init_weights(self, generator: torch.Generator):
        if self.in_channels == 0:
            self.const.normal_(generator=generator)

    def forward(self, x, img, ws_block, noise_mode: str = "random",
                generator: torch.Generator | None = None):
        """ws_block: (B, num_conv + 1, w_dim)."""
        if self.in_channels == 0:
            x = self.const[None].expand(ws_block.shape[0], -1, -1, -1)
        else:
            x = self.conv0(x, ws_block[:, 0], noise_mode=noise_mode, generator=generator)
        x = self.conv1(x, ws_block[:, self.num_conv - 1], noise_mode=noise_mode,
                       generator=generator)
        if img is not None:
            img = upsample2d(img, self.resample_filter, up=2)
        y = self.torgb(x, ws_block[:, self.num_conv])
        img = img + y if img is not None else y
        return x, img


class SynthesisNetwork(nn.Module):
    """The 4 -> img_resolution synthesis pyramid; blocks are ``b4``, ``b8``, ..."""

    def __init__(self, *, w_dim: int = 512, img_resolution: int = 256, img_channels: int = 3,
                 channel_base: int = 32768, channel_max: int = 512,
                 conv_clamp: float | None = None, resample_filter=RESAMPLE_FILTER,
                 device="cuda"):
        super().__init__()
        self.w_dim, self.img_resolution = w_dim, img_resolution
        self.channel_base, self.channel_max = channel_base, channel_max
        self.block_resolutions = [2**i for i in range(2, int(math.log2(img_resolution)) + 1)]
        for res in self.block_resolutions:
            self.add_module(f"b{res}", SynthesisBlock(
                0 if res == 4 else self.channels(res // 2), self.channels(res), w_dim, res,
                img_channels, resample_filter=resample_filter, conv_clamp=conv_clamp,
                device=device))

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def num_ws(self) -> int:
        return num_ws_for_resolution(self.img_resolution)

    def forward(self, ws: torch.Tensor, noise_mode: str = "random",
                generator: torch.Generator | None = None) -> torch.Tensor:
        """ws: (B, num_ws, w_dim) -> (B, img_channels, H, W)."""
        if ws.shape[1] != self.num_ws:
            raise ValueError(f"expected {self.num_ws} ws, got {ws.shape[1]}")
        x = img = None
        w_idx = 0
        for res in self.block_resolutions:
            block = getattr(self, f"b{res}")
            # toRGB uses the w of the next block's first conv (peeks one ahead).
            ws_block = ws[:, w_idx: w_idx + block.num_conv + 1]
            x, img = block(x, img, ws_block, noise_mode=noise_mode, generator=generator)
            w_idx += block.num_conv
        return img


class MappingNetworkAdapted(nn.Module):
    """VisCoIN's adapted mapping: one single-layer MLP per style index; the
    indices ``coarse_layer..mid_layer`` read z1 = Phi, the rest z2 = Phi'.
    The MLPs of a group are stacked (``g1_w0`` is (n, out, in)) and run as
    one batched product. ``fixed_w_avg`` is added to every style vector."""

    def __init__(self, *, z1_dim: int = 9 * 256, z2_dim: int = 9 * 256, w_dim: int = 512,
                 num_ws: int = 14, num_layers: int = 1, activation: str = "lrelu",
                 lr_multiplier: float = 0.01, coarse_layer: int = 2, mid_layer: int = 10,
                 device="cuda"):
        super().__init__()
        self.w_dim, self.num_ws, self.num_layers = w_dim, num_ws, num_layers
        self.activation, self.lr_multiplier = activation, lr_multiplier
        self.g1 = [i for i in range(num_ws) if coarse_layer <= i <= mid_layer]
        self.g2 = [i for i in range(num_ws) if i < coarse_layer or i > mid_layer]
        self.feats = {"g1": [z1_dim] + [w_dim] * num_layers,
                      "g2": [z2_dim] + [w_dim] * num_layers}
        for prefix, idxs in (("g1", self.g1), ("g2", self.g2)):
            if not idxs:
                continue
            feats = self.feats[prefix]
            for layer in range(num_layers):
                self.register_parameter(f"{prefix}_w{layer}", nn.Parameter(torch.empty(
                    len(idxs), feats[layer + 1], feats[layer], device=device)))
                self.register_parameter(f"{prefix}_b{layer}", nn.Parameter(torch.empty(
                    len(idxs), feats[layer + 1], device=device)))
        self.fixed_w_avg = nn.Parameter(torch.empty(w_dim, device=device))

    def init_weights(self, generator: torch.Generator):
        for name, p in self.named_parameters(recurse=False):
            if name.startswith(("g1_w", "g2_w")):
                p.normal_(0.0, 1.0 / self.lr_multiplier, generator=generator)
            else:
                p.zero_()

    def _run_group(self, x: torch.Tensor, prefix: str, n: int) -> torch.Tensor:
        h = x[:, None, :].expand(x.shape[0], n, x.shape[-1])
        for layer in range(self.num_layers):
            w = getattr(self, f"{prefix}_w{layer}")
            b = getattr(self, f"{prefix}_b{layer}")
            scale = self.lr_multiplier / math.sqrt(self.feats[prefix][layer])
            h = torch.einsum("bki,koi->bko", h, (w * scale).to(h.dtype))
            h = h + b[None] * self.lr_multiplier
            h = bias_act(h, None, act=self.activation)
        return h

    def forward(self, z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
        x1 = normalize_2nd_moment(flatten_concepts(z1).float())
        x2 = normalize_2nd_moment(z2.float())
        styles = torch.zeros((x1.shape[0], self.num_ws, self.w_dim), device=x1.device)
        if self.g1:
            styles[:, self.g1] = self._run_group(x1, "g1", len(self.g1))
        if self.g2:
            styles[:, self.g2] = self._run_group(x2, "g2", len(self.g2))
        return styles + self.fixed_w_avg[None, None, :]


class MappingNetwork(nn.Module):
    """The original generator's mapping MLP: normalize_2nd_moment, then
    ``num_layers`` lrelu equalized-LR FCs (``fc0`` ...), broadcast to
    ``num_ws`` style vectors; truncation towards the ``w_avg`` buffer."""

    def __init__(self, *, z_dim: int = 512, w_dim: int = 512, num_ws: int = 14,
                 num_layers: int = 8, lr_multiplier: float = 0.01, device="cuda"):
        super().__init__()
        self.z_dim, self.w_dim, self.num_ws, self.num_layers = z_dim, w_dim, num_ws, num_layers
        features = [z_dim] + [w_dim] * num_layers
        for i in range(num_layers):
            self.add_module(f"fc{i}", FullyConnected(features[i], features[i + 1],
                                                     activation="lrelu",
                                                     lr_multiplier=lr_multiplier, device=device))
        self.register_buffer("w_avg", torch.zeros(w_dim, device=device))

    def forward(self, z: torch.Tensor, truncation_psi: float = 1.0,
                truncation_cutoff: int | None = None) -> torch.Tensor:
        x = normalize_2nd_moment(z.float())
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
        ws = x[:, None, :].expand(-1, self.num_ws, -1)
        if truncation_psi != 1.0:
            cut = self.num_ws if truncation_cutoff is None else truncation_cutoff
            trunc = self.w_avg + truncation_psi * (ws[:, :cut] - self.w_avg)
            ws = torch.cat([trunc, ws[:, cut:]], dim=1)
        return ws


class Generator(nn.Module):
    """The original StyleGAN2 generator: :class:`MappingNetwork` +
    :class:`SynthesisNetwork`; ``forward(z)`` -> (B, img_channels, H, W)."""

    def __init__(self, *, z_dim: int = 512, w_dim: int = 512, img_resolution: int = 256,
                 img_channels: int = 3, mapping_layers: int = 2, channel_base: int = 32768,
                 channel_max: int = 512, conv_clamp: float | None = None, device="cuda"):
        super().__init__()
        self.z_dim = z_dim
        self.synthesis = SynthesisNetwork(
            w_dim=w_dim, img_resolution=img_resolution, img_channels=img_channels,
            channel_base=channel_base, channel_max=channel_max, conv_clamp=conv_clamp,
            device=device)
        self.mapping = MappingNetwork(z_dim=z_dim, w_dim=w_dim, num_ws=self.synthesis.num_ws,
                                      num_layers=mapping_layers, device=device)

    def forward(self, z, truncation_psi: float = 1.0, truncation_cutoff: int | None = None,
                noise_mode: str = "random", generator: torch.Generator | None = None):
        ws = self.mapping(z, truncation_psi=truncation_psi, truncation_cutoff=truncation_cutoff)
        return self.synthesis(ws, noise_mode=noise_mode, generator=generator)


def adapted_state_from_gan(adapted_state: dict, gan_state: dict) -> dict:
    """A :class:`GeneratorAdapted` state dict whose synthesis weights and
    noise buffers are those of a :class:`Generator`'s state dict (the
    counterpart of the JAX package's ``adapted_params_from_gan``)."""
    out = {k: v for k, v in adapted_state.items() if not k.startswith("synthesis.")}
    out.update({k: v for k, v in gan_state.items() if k.startswith("synthesis.")})
    return out


class GeneratorAdapted(nn.Module):
    """StyleGAN adapted for VisCoIN: ``forward(z1=Phi, z2=Phi')`` maps the
    concept spaces through :class:`MappingNetworkAdapted` and synthesizes."""

    def __init__(self, *, z_dim: int = 256, w_dim: int = 512, img_resolution: int = 256,
                 img_channels: int = 3, small_adjust: bool = False, low_res256: bool = False,
                 mapping_num_layers: int = 1, coarse_layer: int = 2, mid_layer: int = 10,
                 channel_base: int = 32768, channel_max: int = 512,
                 conv_clamp: float | None = None, device="cuda"):
        super().__init__()
        self.img_resolution = img_resolution
        self.low_res256 = low_res256
        self.synthesis = SynthesisNetwork(
            w_dim=w_dim, img_resolution=img_resolution, img_channels=img_channels,
            channel_base=channel_base, channel_max=channel_max, conv_clamp=conv_clamp,
            device=device)
        self.mapping = MappingNetworkAdapted(
            z1_dim=9 * z_dim, z2_dim=8 * z_dim if small_adjust else 9 * z_dim, w_dim=w_dim,
            num_ws=num_ws_for_resolution(img_resolution), num_layers=mapping_num_layers,
            coarse_layer=coarse_layer, mid_layer=mid_layer, device=device)

    @property
    def num_ws(self) -> int:
        return num_ws_for_resolution(self.img_resolution)

    def _post(self, img: torch.Tensor) -> torch.Tensor:
        if self.low_res256:
            # Center-crop to (384, 512), then an antialiased bilinear resize
            # to 256², as jax.image.resize(..., "bilinear") does.
            H, W = img.shape[2], img.shape[3]
            top, left = (H - 384) // 2, (W - 512) // 2
            img = img[:, :, top: top + 384, left: left + 512]
            img = F.interpolate(img, size=(256, 256), mode="bilinear", align_corners=False,
                                antialias=True)
        return img

    def forward(self, z1, z2, return_latents: bool = False, noise_mode: str = "random",
                generator: torch.Generator | None = None):
        ws = self.mapping(z1, z2)
        img = self._post(self.synthesis(ws, noise_mode=noise_mode, generator=generator))
        return (img, ws) if return_latents else img

    def gen_from_w(self, w, noise_mode: str = "random",
                   generator: torch.Generator | None = None):
        """Generate directly from W+ latents."""
        return self._post(self.synthesis(w, noise_mode=noise_mode, generator=generator))
