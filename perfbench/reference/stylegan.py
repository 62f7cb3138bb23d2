"""StyleGAN2 (Karras et al., arXiv:1912.04958; the ADA code's architecture,
arXiv:2006.06676) in plain PyTorch: the skip synthesis network, the
original mapping network, VisCoIN's adapted mapping (one single-layer MLP
per style index, arXiv:2407.01331) and the resnet discriminator with the
minibatch standard deviation layer. Equalized learning rate throughout.

Parameter names follow the measured program's state dicts, so the same
seeded weights load into both. Random synthesis noise is drawn layer after
layer from the ``generator`` argument, (B, 1, res, res) per layer, in
block order (conv0, then conv1).

``init_plan`` of each module gives its leaves' initial distributions:
``("normal", mean, std)`` or ``("uniform", lo, hi)``; zero biases and
strengths are perturbed, so every input of the forward matters.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from perfbench.reference.ops import (
    bias_act,
    conv2d_resample,
    modulated_conv2d,
    setup_filter,
    upsample2d,
)

FILTER = (1.0, 3.0, 3.0, 1.0)
PERTURB = 0.1  # std of the noise added to constant initial values


def num_ws(resolution: int) -> int:
    return 2 * int(math.log2(resolution)) - 2


def normalize_2nd_moment(x, eps: float = 1e-8):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)


class FullyConnected(nn.Module):
    def __init__(self, fin, fout, bias=True, activation="linear", lr_multiplier=1.0, bias_init=0.0):
        super().__init__()
        self.fin, self.activation, self.lr = fin, activation, lr_multiplier
        self.bias_init = bias_init
        self.weight = nn.Parameter(torch.empty(fout, fin))
        self.bias = nn.Parameter(torch.empty(fout)) if bias else None

    def init_plan(self):
        plan = {"weight": ("normal", 0.0, 1.0 / self.lr)}
        if self.bias is not None:
            plan["bias"] = ("normal", self.bias_init, PERTURB)
        return plan

    def forward(self, x):
        w = self.weight * (self.lr / math.sqrt(self.fin))
        b = None if self.bias is None else self.bias * self.lr
        return bias_act(x @ w.T, b, act=self.activation)


class Conv2dLayer(nn.Module):
    def __init__(self, cin, cout, k, bias=True, activation="linear", down=1):
        super().__init__()
        self.activation, self.down, self.pad = activation, down, k // 2
        self.gain = 1.0 / math.sqrt(cin * k * k)
        self.filter = setup_filter(FILTER) if down > 1 else None
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def init_plan(self):
        plan = {"weight": ("normal", 0.0, 1.0)}
        if self.bias is not None:
            plan["bias"] = ("normal", 0.0, PERTURB)
        return plan

    def forward(self, x, gain: float = 1.0):
        x = conv2d_resample(x, self.weight * self.gain, f=self.filter, down=self.down,
                            padding=self.pad)
        act_gain = (1.0 if self.activation == "linear" else math.sqrt(2.0)) * gain
        return bias_act(x, self.bias, act=self.activation, gain=act_gain)


class SynthesisLayer(nn.Module):
    def __init__(self, cin, cout, w_dim, res, up=1):
        super().__init__()
        self.res, self.up = res, up
        self.filter = setup_filter(FILTER) if up > 1 else None
        self.affine = FullyConnected(w_dim, cin, bias_init=1.0)
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.noise_strength = nn.Parameter(torch.empty(()))
        self.register_buffer("noise_const", torch.empty(res, res))
        self.bias = nn.Parameter(torch.empty(cout))

    def init_plan(self):
        return {"weight": ("normal", 0.0, 1.0), "bias": ("normal", 0.0, PERTURB),
                "noise_strength": ("normal", 0.0, PERTURB), "noise_const": ("normal", 0.0, 1.0)}

    def forward(self, x, w, noise_mode, generator):
        styles = self.affine(w)
        if noise_mode == "random":
            noise = torch.randn((x.shape[0], 1, self.res, self.res), generator=generator,
                                device=x.device) * self.noise_strength
        else:
            noise = self.noise_const[None, None] * self.noise_strength
        x = modulated_conv2d(x, self.weight, styles, noise=noise, up=self.up, padding=1,
                             resample_filter=self.filter, flip_weight=(self.up == 1))
        return bias_act(x, self.bias, act="lrelu")


class ToRGBLayer(nn.Module):
    def __init__(self, cin, cout, w_dim):
        super().__init__()
        self.gain = 1.0 / math.sqrt(cin)
        self.affine = FullyConnected(w_dim, cin, bias_init=1.0)
        self.weight = nn.Parameter(torch.empty(cout, cin, 1, 1))
        self.bias = nn.Parameter(torch.empty(cout))

    def init_plan(self):
        return {"weight": ("normal", 0.0, 1.0), "bias": ("normal", 0.0, PERTURB)}

    def forward(self, x, w):
        styles = self.affine(w) * self.gain
        x = modulated_conv2d(x, self.weight, styles, demodulate=False)
        return bias_act(x, self.bias)


class SynthesisBlock(nn.Module):
    def __init__(self, cin, cout, w_dim, res, img_channels):
        super().__init__()
        self.cin = cin
        self.filter = setup_filter(FILTER)
        if cin == 0:
            self.const = nn.Parameter(torch.empty(cout, 4, 4))
        else:
            self.conv0 = SynthesisLayer(cin, cout, w_dim, res, up=2)
        self.conv1 = SynthesisLayer(cout, cout, w_dim, res)
        self.torgb = ToRGBLayer(cout, img_channels, w_dim)
        self.num_conv = 1 if cin == 0 else 2

    def init_plan(self):
        return {"const": ("normal", 0.0, 1.0)} if self.cin == 0 else {}

    def forward(self, x, img, ws, noise_mode, generator):
        if self.cin == 0:
            x = self.const[None].expand(ws.shape[0], -1, -1, -1)
        else:
            x = self.conv0(x, ws[:, 0], noise_mode, generator)
        x = self.conv1(x, ws[:, self.num_conv - 1], noise_mode, generator)
        if img is not None:
            img = upsample2d(img, self.filter)
        y = self.torgb(x, ws[:, self.num_conv])
        return x, (y if img is None else img + y)


class SynthesisNetwork(nn.Module):
    def __init__(self, w_dim, resolution, img_channels, channel_base, channel_max):
        super().__init__()
        self.resolutions = [2**i for i in range(2, int(math.log2(resolution)) + 1)]
        ch = lambda r: min(channel_base // r, channel_max)  # noqa: E731
        for r in self.resolutions:
            self.add_module(f"b{r}", SynthesisBlock(0 if r == 4 else ch(r // 2), ch(r), w_dim,
                                                    r, img_channels))

    def forward(self, ws, noise_mode="random", generator=None):
        x = img = None
        i = 0
        for r in self.resolutions:
            block = getattr(self, f"b{r}")
            x, img = block(x, img, ws[:, i: i + block.num_conv + 1], noise_mode, generator)
            i += block.num_conv
        return img


class MappingNetwork(nn.Module):
    def __init__(self, z_dim, w_dim, n_ws, layers, lr_multiplier=0.01):
        super().__init__()
        self.layers, self.n_ws = layers, n_ws
        dims = [z_dim] + [w_dim] * layers
        for i in range(layers):
            self.add_module(f"fc{i}", FullyConnected(dims[i], dims[i + 1], activation="lrelu",
                                                     lr_multiplier=lr_multiplier))
        self.register_buffer("w_avg", torch.empty(w_dim))

    def init_plan(self):
        return {"w_avg": ("normal", 0.0, PERTURB)}

    def forward(self, z):
        x = normalize_2nd_moment(z)
        for i in range(self.layers):
            x = getattr(self, f"fc{i}")(x)
        return x[:, None].expand(-1, self.n_ws, -1)


class Generator(nn.Module):
    """The original StyleGAN2 generator."""

    def __init__(self, z_dim, w_dim, resolution, mapping_layers, channel_base, channel_max,
                 img_channels=3):
        super().__init__()
        self.z_dim, self.resolution, self.n_ws = z_dim, resolution, num_ws(resolution)
        self.synthesis = SynthesisNetwork(w_dim, resolution, img_channels, channel_base,
                                          channel_max)
        self.mapping = MappingNetwork(z_dim, w_dim, self.n_ws, mapping_layers)

    def forward(self, z, noise_mode="random", generator=None):
        return self.synthesis(self.mapping(z), noise_mode, generator)


class MappingNetworkAdapted(nn.Module):
    """VisCoIN's mapping: style index i in [coarse, mid] from Phi (9K), the
    others from Phi' (9K), each through its own lrelu FC; plus fixed_w_avg."""

    def __init__(self, z_dim, w_dim, n_ws, coarse=2, mid=10, lr_multiplier=0.01):
        super().__init__()
        self.n_ws, self.lr = n_ws, lr_multiplier
        self.g1 = [i for i in range(n_ws) if coarse <= i <= mid]
        self.g2 = [i for i in range(n_ws) if i < coarse or i > mid]
        self.fin = 9 * z_dim
        for p, idx in (("g1", self.g1), ("g2", self.g2)):
            self.register_parameter(f"{p}_w0", nn.Parameter(torch.empty(len(idx), w_dim, self.fin)))
            self.register_parameter(f"{p}_b0", nn.Parameter(torch.empty(len(idx), w_dim)))
        self.fixed_w_avg = nn.Parameter(torch.empty(w_dim))

    def init_plan(self):
        w = ("normal", 0.0, 1.0 / self.lr)
        b = ("normal", 0.0, PERTURB)
        return {"g1_w0": w, "g2_w0": w, "g1_b0": b, "g2_b0": b, "fixed_w_avg": b}

    def _group(self, x, p, n):
        h = x[:, None, :].expand(x.shape[0], n, x.shape[-1])
        w = getattr(self, f"{p}_w0") * (self.lr / math.sqrt(self.fin))
        h = torch.einsum("bki,koi->bko", h, w) + getattr(self, f"{p}_b0")[None] * self.lr
        return bias_act(h, None, act="lrelu")

    def forward(self, phi, phi_prime):
        x1 = normalize_2nd_moment(phi.reshape(phi.shape[0], -1))
        x2 = normalize_2nd_moment(phi_prime)
        ws = torch.zeros((x1.shape[0], self.n_ws, self.fixed_w_avg.shape[0]), device=x1.device)
        ws[:, self.g1] = self._group(x1, "g1", len(self.g1))
        ws[:, self.g2] = self._group(x2, "g2", len(self.g2))
        return ws + self.fixed_w_avg[None, None]


class GeneratorAdapted(nn.Module):
    def __init__(self, z_dim, w_dim, resolution, channel_base, channel_max, img_channels=3):
        super().__init__()
        self.synthesis = SynthesisNetwork(w_dim, resolution, img_channels, channel_base,
                                          channel_max)
        self.mapping = MappingNetworkAdapted(z_dim, w_dim, num_ws(resolution))


class MinibatchStd(nn.Module):
    def __init__(self, group_size):
        super().__init__()
        self.group_size = group_size

    def forward(self, x):
        B, C, H, W = x.shape
        G = min(self.group_size, B)
        G = B // (B // G) if B % G == 0 else 1
        y = x.reshape(G, B // G, 1, C, H, W)
        y = torch.sqrt((y - y.mean(dim=0)).square().mean(dim=0) + 1e-8)
        y = y.mean(dim=(2, 3, 4)).repeat(G, 1)
        return torch.cat([x, y[:, :, None, None].expand(B, 1, H, W)], dim=1)


class DiscriminatorBlock(nn.Module):
    def __init__(self, cin, tmp, cout, img_channels):
        super().__init__()
        self.cin = cin
        if cin == 0:
            self.fromrgb = Conv2dLayer(img_channels, tmp, 1, activation="lrelu")
        self.skip = Conv2dLayer(tmp, cout, 1, bias=False, down=2)
        self.conv0 = Conv2dLayer(tmp, tmp, 3, activation="lrelu")
        self.conv1 = Conv2dLayer(tmp, cout, 3, activation="lrelu", down=2)

    def forward(self, x, img):
        if self.cin == 0:
            x = self.fromrgb(img)
        y = self.skip(x, gain=math.sqrt(0.5))
        return y + self.conv1(self.conv0(x), gain=math.sqrt(0.5))


class Discriminator(nn.Module):
    def __init__(self, resolution, channel_base, channel_max, mbstd_group, img_channels=3):
        super().__init__()
        ch = lambda r: min(channel_base // r, channel_max)  # noqa: E731
        self.resolutions = [2**i for i in range(int(math.log2(resolution)), 2, -1)]
        for i, r in enumerate(self.resolutions):
            self.add_module(f"b{r}", DiscriminatorBlock(0 if i == 0 else ch(r), ch(r), ch(r // 2),
                                                        img_channels))
        self.mbstd = MinibatchStd(mbstd_group)
        self.conv = Conv2dLayer(ch(4) + 1, ch(4), 3, activation="lrelu")
        self.fc = FullyConnected(ch(4) * 16, ch(4), activation="lrelu")
        self.out = FullyConnected(ch(4), 1)

    def forward(self, img):
        x = None
        for i, r in enumerate(self.resolutions):
            x = getattr(self, f"b{r}")(x, img if i == 0 else None)
        x = self.conv(self.mbstd(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (h, w, c) order, as the program's
        return self.out(self.fc(x))
