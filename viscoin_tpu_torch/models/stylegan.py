"""StyleGAN2 generators and discriminator, NCHW / OIHW.

Counterpart of ``viscoin_tpu/models/stylegan.py``: the equalized-LR
:class:`FullyConnected` and :class:`Conv2dLayer`, :class:`SynthesisLayer`,
:class:`ToRGBLayer`, :class:`SynthesisBlock` (skip architecture),
:class:`SynthesisNetwork`, :class:`MappingNetworkAdapted` (the
per-style-layer MLPs stacked into two groups) and :class:`GeneratorAdapted`;
the original :class:`MappingNetwork` and :class:`Generator` (the frozen
source of VisCoIN's synthetic training images, and what ``train gan``
trains), with :func:`generator_config_from_params`; :class:`MinibatchStdLayer`,
:class:`DiscriminatorBlock` (resnet architecture) and :class:`Discriminator`;
and :func:`adapted_state_from_gan`.
Parameter names and shapes follow the JAX modules, with conv weights in OIHW
and the 4x4 constant in CHW, so ``utils/weights.py`` carries the JAX
variables across by name. The discriminator's epilogue flattens its 4x4
features in JAX's (h, w, c) order, so the ``fc`` weight is JAX's as it is.

Mixed precision (stylegan2-ada-pytorch's ``num_fp16_res``): the G and D
blocks at the ``num_fp16_res`` highest resolutions (from 8² up,
:func:`fp16_resolution`) run their activations in float16, with float32
weights cast at each use; G's running RGB image, the mapping and D's 4²
epilogue stay float32. Such a block casts its input at entry and runs in the
span ``g_fp16`` or ``d_fp16``. Every block call is counted by the dtype it
ran in (``utils/tracing.py::precision_counts``). With ``num_fp16_res`` 0 no
block casts (a bfloat16 run casts the whole network, ``train/gan.py``).

``noise_mode`` is "random" (drawn from the ``generator`` argument, a
``torch.Generator`` on the activations' device), "const" (the ``noise_const``
buffers) or "none".

The synthesis takes ``spatial`` (``parallel/spatial.py``): each plane "g.<res>"
of the shard plan is computed on this rank's rows (halo exchanges in the
convs and the skip upsample) or whole, and scattered where the plan starts
sharding; a layer's random noise is drawn for the whole plane and its rows
kept, so the ranks draw what one process draws. The image comes back as this
rank's rows. The discriminator takes ``spatial`` too: each plane "d.<res>" is
computed on this rank's rows (the down-2 convs' FIR and strided conv read one
halo-extended window) or whole, gathered where the plan stops sharding; the
minibatch stddev sums its mean over the model group, and the 4² features are
gathered whole for ``fc``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from viscoin_tpu_torch.ops import (
    bias_act,
    conv2d_resample,
    modulated_conv2d,
    setup_filter,
    upsample2d,
)
from viscoin_tpu_torch.ops.bias_act import activation_funcs
from viscoin_tpu_torch.parallel import spatial as S
from viscoin_tpu_torch.parallel.mesh import all_gather_batch
from viscoin_tpu_torch.utils import tracing

RESAMPLE_FILTER = (1.0, 3.0, 3.0, 1.0)


def num_ws_for_resolution(img_resolution: int) -> int:
    """Style vectors of a skip synthesis pyramid: 1 conv at 4², 2 per higher
    block, +1 for the last toRGB (14 at 256²)."""
    return 2 * int(math.log2(img_resolution)) - 2


def fp16_resolution(img_resolution: int, num_fp16_res: int) -> int:
    """The lowest resolution whose blocks run in float16 (upstream's
    ``max(2 ** (log2(res) + 1 - num_fp16_res), 8)``; above the image's when
    ``num_fp16_res`` is 0)."""
    return max(2 ** (int(math.log2(img_resolution)) + 1 - num_fp16_res), 8)


def block_dtype(resolution: int, img_resolution: int, num_fp16_res: int):
    """A block's compute dtype in a mixed-precision network: float16 from
    :func:`fp16_resolution` up, float32 below; None (whatever comes in, no
    cast) when ``num_fp16_res`` is 0."""
    if num_fp16_res <= 0:
        return None
    if resolution >= fp16_resolution(img_resolution, num_fp16_res):
        return torch.float16
    return torch.float32


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


class Conv2dLayer(nn.Module):
    """Plain (not modulated) equalized-LR conv + bias_act, with optional
    up/down resampling through the FIR filter; ``forward(x, gain)`` scales
    the activation's gain and the clamp by ``gain``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, *,
                 use_bias: bool = True, activation: str = "linear", up: int = 1, down: int = 1,
                 resample_filter=RESAMPLE_FILTER, conv_clamp: float | None = None,
                 device="cuda"):
        super().__init__()
        self.activation, self.up, self.down, self.conv_clamp = activation, up, down, conv_clamp
        self.padding = kernel_size // 2
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size * kernel_size)
        self.resample_filter = (setup_filter(list(resample_filter))
                                if up > 1 or down > 1 else None)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size,
                                               kernel_size, device=device))
        self.bias = (nn.Parameter(torch.empty(out_channels, device=device))
                     if use_bias else None)

    def init_weights(self, generator: torch.Generator):
        self.weight.normal_(generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor, gain: float = 1.0,
                sp: S.Spatial | None = None) -> torch.Tensor:
        """``sp``: ``x`` is this rank's rows of an H-sharded plane."""
        w = (self.weight * self.weight_gain).to(x.dtype)
        x = conv2d_resample(x, w, f=self.resample_filter, up=self.up, down=self.down,
                            padding=self.padding, flip_weight=(self.up == 1), sp=sp)
        clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        act_gain = activation_funcs[self.activation].def_gain * gain
        return bias_act(x, self.bias, act=self.activation, gain=act_gain, clamp=clamp)


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
                gain: float = 1.0, generator: torch.Generator | None = None,
                sp: S.Spatial | None = None) -> torch.Tensor:
        """``sp``: ``x`` is this rank's rows of an H-sharded plane (the noise
        plane is drawn whole and its rows kept)."""
        if noise_mode not in ("random", "const", "none"):
            raise ValueError(f"noise_mode must be random, const or none: {noise_mode!r}")
        styles = self.affine(w.float())
        noise = None
        if self.use_noise and noise_mode == "random":
            noise = torch.randn((x.shape[0], 1, self.resolution, self.resolution),
                                generator=generator, device=x.device)
            if sp is not None:
                noise = noise[:, :, sp.rows(self.resolution)]
            noise = noise * self.noise_strength
        elif self.use_noise and noise_mode == "const":
            const = self.noise_const if sp is None else self.noise_const[sp.rows(self.resolution)]
            noise = const[None, None] * self.noise_strength
        x = modulated_conv2d(x, self.weight, styles, noise=noise, up=self.up,
                             padding=self.padding, resample_filter=self.resample_filter,
                             flip_weight=(self.up == 1), sp=sp)
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

    def forward(self, x: torch.Tensor, w: torch.Tensor,
                sp: S.Spatial | None = None) -> torch.Tensor:
        styles = self.affine(w.float())
        x = modulated_conv2d(x, self.weight, styles * self.weight_gain, demodulate=False,
                             padding=self.padding, sp=sp)
        return bias_act(x, self.bias, act="linear", clamp=self.conv_clamp)


class SynthesisBlock(nn.Module):
    """One resolution of the skip architecture: (conv0, up 2), conv1, toRGB,
    and the upsampled running image."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int,
                 img_channels: int, *, resample_filter=RESAMPLE_FILTER,
                 conv_clamp: float | None = None, dtype: torch.dtype | None = None,
                 device="cuda"):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.resolution = resolution
        self.dtype = dtype  # None: no cast; float16 / float32 in a mixed-precision network
        self.name = f"g{resolution}"
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
                generator: torch.Generator | None = None, sp: S.Spatial | None = None):
        """ws_block: (B, num_conv + 1, w_dim). ``sp``: ``x`` and ``img`` come
        in the layout of the plan's plane "g.<res / 2>" and this block's
        planes are in that of "g.<res>" (a whole input is scattered after
        the layer that reads it). A float16 block returns ``x`` in float16
        and ``img`` in float32."""
        if self.dtype == torch.float16:
            with tracing.fp16_region("g_fp16") as region:
                x, img, ws_block = region.enter(x, img, ws_block)
                x, img = self._forward(x, img, ws_block, noise_mode, generator, sp)
                return region.exit(x, img)
        return self._forward(x, img, ws_block, noise_mode, generator, sp)

    def _forward(self, x, img, ws_block, noise_mode, generator, sp):
        src, dst = f"g.{self.resolution // 2}", f"g.{self.resolution}"
        if self.in_channels == 0:
            x = self.const[None].expand(ws_block.shape[0], -1, -1, -1)
            if self.dtype is not None:
                x = x.to(self.dtype)
            x = S.convert(x, sp, None, dst)
        else:
            if self.dtype is not None:
                x = x.to(self.dtype)
            x = self.conv0(x, ws_block[:, 0], noise_mode=noise_mode, generator=generator,
                           sp=S.at(sp, src))
            x = S.convert(x, sp, src, dst)
        tracing.count_block(self.name, x.dtype)
        x = self.conv1(x, ws_block[:, self.num_conv - 1], noise_mode=noise_mode,
                       generator=generator, sp=S.at(sp, dst))
        if img is not None:
            img = S.convert(upsample2d(img, self.resample_filter, up=2, sp=S.at(sp, src)), sp,
                            src, dst)
        y = self.torgb(x, ws_block[:, self.num_conv], sp=S.at(sp, dst))
        if self.dtype is not None:
            y = y.float()  # the running image stays float32
        img = img + y if img is not None else y
        return x, img


class SynthesisNetwork(nn.Module):
    """The 4 -> img_resolution synthesis pyramid; blocks are ``b4``, ``b8``, ..."""

    def __init__(self, *, w_dim: int = 512, img_resolution: int = 256, img_channels: int = 3,
                 channel_base: int = 32768, channel_max: int = 512,
                 conv_clamp: float | None = None, resample_filter=RESAMPLE_FILTER,
                 num_fp16_res: int = 0, device="cuda"):
        super().__init__()
        self.w_dim, self.img_resolution, self.img_channels = w_dim, img_resolution, img_channels
        self.channel_base, self.channel_max = channel_base, channel_max
        self.num_fp16_res = num_fp16_res
        self.block_resolutions = [2**i for i in range(2, int(math.log2(img_resolution)) + 1)]
        for res in self.block_resolutions:
            self.add_module(f"b{res}", SynthesisBlock(
                0 if res == 4 else self.channels(res // 2), self.channels(res), w_dim, res,
                img_channels, resample_filter=resample_filter, conv_clamp=conv_clamp,
                dtype=block_dtype(res, img_resolution, num_fp16_res), device=device))

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def num_ws(self) -> int:
        return num_ws_for_resolution(self.img_resolution)

    def forward(self, ws: torch.Tensor, noise_mode: str = "random",
                generator: torch.Generator | None = None,
                spatial: S.Spatial | None = None) -> torch.Tensor:
        """ws: (B, num_ws, w_dim) -> (B, img_channels, H, W); with
        ``spatial``, this rank's rows of the image (the last plane of the
        plan must be sharded)."""
        if ws.shape[1] != self.num_ws:
            raise ValueError(f"expected {self.num_ws} ws, got {ws.shape[1]}")
        if spatial is not None and not S.sharded(spatial, f"g.{self.img_resolution}"):
            raise ValueError(f"the {self.img_resolution}² image cannot be H-sharded over "
                             f"{spatial.model} model ranks")
        x = img = None
        w_idx = 0
        for res in self.block_resolutions:
            block = getattr(self, f"b{res}")
            # toRGB uses the w of the next block's first conv (peeks one ahead).
            ws_block = ws[:, w_idx: w_idx + block.num_conv + 1]
            x, img = block(x, img, ws_block, noise_mode=noise_mode, generator=generator,
                           sp=spatial)
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
        self.g2_before = sum(i < coarse_layer for i in self.g2)
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
        # g1 is one run of indices and g2 those before and after it, so the
        # styles in index order are one concatenation: an index list would be
        # copied to the card on every call, which a CUDA graph cannot hold.
        empty = (x1.shape[0], 0, self.w_dim)
        h1 = self._run_group(x1, "g1", len(self.g1)) if self.g1 else x1.new_zeros(empty)
        h2 = self._run_group(x2, "g2", len(self.g2)) if self.g2 else x2.new_zeros(empty)
        k = self.g2_before
        return torch.cat([h2[:, :k], h1, h2[:, k:]], dim=1) + self.fixed_w_avg[None, None, :]


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
                 channel_max: int = 512, conv_clamp: float | None = None, num_fp16_res: int = 0,
                 device="cuda"):
        super().__init__()
        # The JAX module's hyperparameters; the port's num_fp16_res where it is set.
        self.config = dict(z_dim=z_dim, w_dim=w_dim, img_resolution=img_resolution,
                           img_channels=img_channels, mapping_layers=mapping_layers,
                           channel_base=channel_base, channel_max=channel_max,
                           conv_clamp=conv_clamp)
        if num_fp16_res:
            self.config["num_fp16_res"] = num_fp16_res
        self.z_dim, self.w_dim, self.img_resolution = z_dim, w_dim, img_resolution
        self.num_fp16_res = num_fp16_res
        self.synthesis = SynthesisNetwork(
            w_dim=w_dim, img_resolution=img_resolution, img_channels=img_channels,
            channel_base=channel_base, channel_max=channel_max, conv_clamp=conv_clamp,
            num_fp16_res=num_fp16_res, device=device)
        self.mapping = MappingNetwork(z_dim=z_dim, w_dim=w_dim, num_ws=self.synthesis.num_ws,
                                      num_layers=mapping_layers, device=device)

    def forward(self, z, truncation_psi: float = 1.0, truncation_cutoff: int | None = None,
                noise_mode: str = "random", generator: torch.Generator | None = None,
                spatial: S.Spatial | None = None):
        """``spatial``: the mapping runs whole, the synthesis H-sharded; the
        image comes back as this rank's rows."""
        ws = self.mapping(z, truncation_psi=truncation_psi, truncation_cutoff=truncation_cutoff)
        return self.synthesis(ws, noise_mode=noise_mode, generator=generator, spatial=spatial)


def synthesis_config_from_params(syn: dict) -> dict:
    """A :class:`SynthesisNetwork`'s resolution, image channels and widths
    from its params in the JAX layout (HWIO weights)."""
    import numpy as np

    resolutions = sorted(int(k[1:]) for k in syn)
    img_resolution = max(resolutions)
    widths = {r: int(np.shape(syn[f"b{r}"]["conv1"]["weight"])[-1]) for r in resolutions}
    channel_max = max(widths.values())
    channel_base = max(w * r for r, w in widths.items())
    for r, w in widths.items():
        if min(channel_base // r, channel_max) != w:
            raise ValueError(f"synthesis widths {widths} do not follow the StyleGAN2 "
                             "min(channel_base//res, channel_max) schedule — cannot infer the "
                             "module config; construct the Generator explicitly")
    return {"img_resolution": img_resolution, "channel_base": channel_base,
            "channel_max": channel_max,
            # the top block's toRGB output width is the image channel count
            "img_channels": int(np.shape(syn[f"b{img_resolution}"]["torgb"]["weight"])[-1])}


def generator_config_from_params(params: dict, recorded: dict | None = None) -> dict:
    """A :class:`Generator`'s constructor config from its params in the JAX
    layout (a ``train gan`` export or a ``port-weights stylegan`` output, as
    ``utils/checkpoints.py::restore_pytree`` reads them): resolution, image
    channels and widths from the synthesis blocks, latent sizes and depth
    from the mapping. The dict of the JAX package's function of that name,
    plus ``num_fp16_res`` and ``conv_clamp`` where the export ``recorded``
    them (its "config" entry, :func:`recorded_config`)."""
    import numpy as np

    syn = synthesis_config_from_params(params["synthesis"])
    mapping = params["mapping"]
    fcs = sorted(k for k in mapping if k.startswith("fc"))
    if not fcs:
        raise ValueError("params['mapping'] has no fc{i} layers — an adapted (VisCoIN) "
                         "mapping? config inference covers the original Generator only")
    out = {"z_dim": int(np.shape(mapping[fcs[0]]["weight"])[1]),
           "w_dim": int(np.shape(mapping[fcs[-1]]["weight"])[0]),
           "img_resolution": syn["img_resolution"], "mapping_layers": len(fcs),
           "channel_base": syn["channel_base"], "channel_max": syn["channel_max"],
           "img_channels": syn["img_channels"]}
    if recorded:
        if "num_fp16_res" in recorded:
            out["num_fp16_res"] = int(np.asarray(recorded["num_fp16_res"]))
        if "conv_clamp" in recorded:
            out["conv_clamp"] = float(np.asarray(recorded["conv_clamp"]))
    return out


def recorded_config(generator: "Generator") -> dict:
    """What a generator export records beside its weights (the tree's
    "config" entry): ``num_fp16_res`` and ``conv_clamp`` where set, which its
    params cannot tell; empty for the JAX package's configurations."""
    import numpy as np

    out = {}
    if generator.num_fp16_res:
        out["num_fp16_res"] = np.asarray(generator.num_fp16_res, np.int64)
    if generator.config["conv_clamp"] is not None:
        out["conv_clamp"] = np.asarray(generator.config["conv_clamp"], np.float32)
    return out


class MinibatchStdLayer(nn.Module):
    """Append the feature stddev across each group of samples as extra
    channels. Group m holds samples {m, m + B/G, ...} (a (G, B/G) reshape),
    so the stats are tiled, not interleaved, over the batch."""

    def __init__(self, group_size: int = 4, num_channels: int = 1):
        super().__init__()
        self.group_size, self.num_channels = group_size, num_channels

    def forward(self, x: torch.Tensor, mesh=None, sp: S.Spatial | None = None) -> torch.Tensor:
        """With a data-parallel ``mesh`` the groups are those of the global
        batch, as the JAX layer's under GSPMD: a group spans the ranks of
        the data axis, so the statistic is taken over the batch gathered
        along it (differentiably) and each rank keeps its own samples.
        ``sp``: ``x`` is this rank's rows of an H-sharded plane, and the
        mean over (C, H, W) sums over the model group."""
        b, C, H, W = x.shape
        xg = all_gather_batch(x.float(), None if mesh is None else mesh.data_axis)
        B = xg.shape[0]
        G = min(self.group_size, B)
        G = B // (B // G) if B % G == 0 else 1
        F_ = self.num_channels
        y = xg.reshape(G, B // G, F_, C // F_, H, W)
        y = y - y.mean(dim=0, keepdim=True)
        y = torch.sqrt(y.square().mean(dim=0) + 1e-8)
        if sp is None:
            y = y.mean(dim=(2, 3, 4))  # (B // G, F)
        else:
            y = S.model_sum(y.sum(dim=(2, 3, 4)), sp) / (C // F_ * H * sp.model * W)
        y = y.repeat(G, 1).to(x.dtype)  # (B, F): sample s takes y[s % (B // G)]
        if mesh is not None:
            y = y[mesh.rows(b)]
        return torch.cat([x, y[:, :, None, None].expand(b, F_, H, W)], dim=1)


class DiscriminatorBlock(nn.Module):
    """fromRGB (first block only) and two convs, the second down 2, with a
    residual 1x1 down-2 ``skip`` (the resnet architecture); the ``sqrt(0.5)``
    gains of skip and conv1 scale their clamps too. ``resolution``: its
    input's, which names its planes under model parallelism."""

    def __init__(self, in_channels: int, tmp_channels: int, out_channels: int, *,
                 img_channels: int = 3, architecture: str = "resnet",
                 resample_filter=RESAMPLE_FILTER, conv_clamp: float | None = None,
                 resolution: int | None = None, dtype: torch.dtype | None = None,
                 device="cuda"):
        super().__init__()
        self.in_channels, self.resolution = in_channels, resolution
        self.dtype = dtype  # None: no cast; float16 / float32 in a mixed-precision network
        self.name = f"d{resolution}"
        if in_channels == 0:
            self.fromrgb = Conv2dLayer(img_channels, tmp_channels, 1, activation="lrelu",
                                       conv_clamp=conv_clamp, device=device)
        self.skip = (Conv2dLayer(tmp_channels, out_channels, 1, use_bias=False, down=2,
                                 resample_filter=resample_filter, device=device)
                     if architecture == "resnet" else None)
        self.conv0 = Conv2dLayer(tmp_channels, tmp_channels, 3, activation="lrelu",
                                 conv_clamp=conv_clamp, device=device)
        self.conv1 = Conv2dLayer(tmp_channels, out_channels, 3, activation="lrelu", down=2,
                                 resample_filter=resample_filter, conv_clamp=conv_clamp,
                                 device=device)

    def forward(self, x, img, sp: S.Spatial | None = None):
        """``sp``: ``x`` and ``img`` come in the layout of the plan's plane
        "d.<resolution>" and the output goes in that of "d.<resolution / 2>"
        (gathered where the plan stops sharding). A float16 block takes its
        inputs in any dtype and returns float16."""
        if self.dtype == torch.float16:
            with tracing.fp16_region("d_fp16") as region:
                x, img = region.enter(x, img)
                (x,) = region.exit(self._forward(x, img, sp))
                return x
        return self._forward(x, img, sp)

    def _forward(self, x, img, sp):
        src = dst = None
        if sp is not None:
            src, dst = f"d.{self.resolution}", f"d.{self.resolution // 2}"
        on = S.at(sp, src)
        if self.dtype is not None:
            x = None if x is None else x.to(self.dtype)
            img = None if img is None else img.to(self.dtype)
        if self.in_channels == 0:
            x_in = self.fromrgb(img, sp=on)
            x = x_in if x is None else x + x_in
        tracing.count_block(self.name, x.dtype)
        y = self.skip(x, gain=math.sqrt(0.5), sp=on) if self.skip is not None else None
        x = self.conv0(x, sp=on)
        x = self.conv1(x, gain=math.sqrt(0.5) if y is not None else 1.0, sp=on)
        return S.convert(y + x if y is not None else x, sp, src, dst)


class Discriminator(nn.Module):
    """The StyleGAN2 discriminator: resnet blocks ``b<res>`` from
    ``img_resolution`` down to 8, then the 4x4 epilogue (``mbstd``, ``conv``,
    ``fc``, ``out``); ``forward(img)`` -> (B, 1) logits."""

    def __init__(self, *, img_resolution: int = 256, img_channels: int = 3,
                 channel_base: int = 32768, channel_max: int = 512, mbstd_group_size: int = 4,
                 conv_clamp: float | None = None, num_fp16_res: int = 0, device="cuda"):
        super().__init__()
        # The JAX module's hyperparameters; the port's num_fp16_res where it is set.
        self.config = dict(img_resolution=img_resolution, img_channels=img_channels,
                           channel_base=channel_base, channel_max=channel_max,
                           mbstd_group_size=mbstd_group_size, conv_clamp=conv_clamp)
        if num_fp16_res:
            self.config["num_fp16_res"] = num_fp16_res
        self.channel_base, self.channel_max = channel_base, channel_max
        self.num_fp16_res = num_fp16_res
        self.resolutions = [2**i for i in range(int(math.log2(img_resolution)), 2, -1)]
        for i, res in enumerate(self.resolutions):
            self.add_module(f"b{res}", DiscriminatorBlock(
                0 if i == 0 else self.channels(res), self.channels(res),
                self.channels(res // 2), img_channels=img_channels, conv_clamp=conv_clamp,
                resolution=res, dtype=block_dtype(res, img_resolution, num_fp16_res),
                device=device))
        ch4 = self.channels(4)
        self.mbstd = MinibatchStdLayer(mbstd_group_size)
        self.conv = Conv2dLayer(ch4 + 1, ch4, 3, activation="lrelu", conv_clamp=conv_clamp,
                                device=device)
        self.fc = FullyConnected(ch4 * 16, ch4, activation="lrelu", device=device)
        self.out = FullyConnected(ch4, 1, device=device)

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    def forward(self, img: torch.Tensor, mesh=None,
                spatial: S.Spatial | None = None) -> torch.Tensor:
        """``mesh``: the data-parallel mesh whose global batch the
        minibatch stddev groups span (None: this batch alone). ``spatial``:
        ``img`` is this rank's rows (the plan's first plane "d.<res>" must be
        sharded), every plane of the plan is computed on its rows, and the
        4² features are gathered whole for ``fc``, so the logits are whole
        on every rank of a model group."""
        top = self.resolutions[0]
        if spatial is not None and not S.sharded(spatial, f"d.{top}"):
            raise ValueError(f"the {top}² image cannot be H-sharded over {spatial.model} "
                             "model ranks")
        x = None
        for i, res in enumerate(self.resolutions):
            x = getattr(self, f"b{res}")(x, img if i == 0 else None, sp=spatial)
        on = S.at(spatial, "d.4")
        if self.num_fp16_res:
            x = x.float()  # the epilogue runs in float32
        x = S.convert(self.conv(self.mbstd(x, mesh, sp=on), sp=on), spatial, "d.4", None)
        # JAX flattens NHWC: the fc's input runs over (h, w, c).
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.out(self.fc(x))


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

    def __init__(self, *, z_dim: int = 256, c_dim: int = 0, w_dim: int = 512,
                 img_resolution: int = 256, img_channels: int = 3, small_adjust: bool = False,
                 low_res256: bool = False, mapping_num_layers: int = 1, coarse_layer: int = 2,
                 mid_layer: int = 10, channel_base: int = 32768, channel_max: int = 512,
                 conv_clamp: float | None = None, device="cuda"):
        super().__init__()
        if c_dim:
            raise ValueError("a conditional (c_dim > 0) adapted generator does not exist in "
                             "VisCoIN")
        # The hyperparameters a checkpoint records, as the JAX module names them.
        self.config = dict(z_dim=z_dim, c_dim=c_dim, w_dim=w_dim, img_resolution=img_resolution,
                           img_channels=img_channels, small_adjust=small_adjust,
                           low_res256=low_res256, mapping_num_layers=mapping_num_layers,
                           coarse_layer=coarse_layer, mid_layer=mid_layer,
                           channel_base=channel_base, channel_max=channel_max,
                           conv_clamp=conv_clamp)
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

    def _post(self, img: torch.Tensor, spatial: S.Spatial | None = None) -> torch.Tensor:
        """The ``low_res256`` crop and resize; ``spatial``: ``img`` is this
        rank's rows, gathered for the resize and scattered after it."""
        if self.low_res256 and spatial is not None:
            return S.scatter_rows(self._post(S.gather_rows(img, spatial)), spatial)
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
                generator: torch.Generator | None = None, spatial: S.Spatial | None = None):
        """``spatial``: the mapping runs whole, the synthesis H-sharded; the
        image comes back as this rank's rows."""
        ws = self.mapping(z1, z2)
        img = self.gen_from_w(ws, noise_mode=noise_mode, generator=generator, spatial=spatial)
        return (img, ws) if return_latents else img

    def gen_from_w(self, w, noise_mode: str = "random",
                   generator: torch.Generator | None = None, spatial: S.Spatial | None = None):
        """Generate directly from W+ latents."""
        return self._post(self.synthesis(w, noise_mode=noise_mode, generator=generator,
                                         spatial=spatial), spatial)
