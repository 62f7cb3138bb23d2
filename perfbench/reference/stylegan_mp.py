"""StyleGAN2-ADA as stylegan2-ada-pytorch configures it for its published
settings (Karras et al., arXiv:2006.06676; ``train.py``'s ``cfg_specs``):
every bias-activation clamped to ±``conv_clamp``·gain, the mapping depth
of the configuration, the path length on the first ``batch //
pl_batch_shrink`` rows, in plain PyTorch.

This is the reference of the configurations whose blocks run in a 16-bit
type (``num_fp16_res``). It computes every block in float32: the float16
pre-normalisation of the modulated convolution (``w`` and the styles scaled
before the product, so that float16 holds it) is an identity under
demodulation and is left out. ``low_dtype`` computes the blocks from
:func:`low_resolution` up in another type instead (the control's bfloat16,
or float16 where FLOPs and bytes are counted at the precision the
configuration states): activations cast at each block's entry, weights at
each use, the running RGB image, the mapping and D's 4² epilogue in
float32, as upstream runs its float16 blocks. ``round_dtype`` takes each
block's activations through a lower type and back at its entry and exit
(the bfloat16 cell's control: float8 e5m2).

The ADA pipe is the 'bgc' pipe of ``steps.py`` with the two-pass warp
written as gathers of the two samples each output reads (the dense
interpolation matrices of ``steps.py`` hold B·H³ elements, 17 GB per pass at
1024² and batch 4).

:class:`MixedCount` counts the FLOPs of a block by the dtype of each
operation's first input and the bytes of the two kernels by the dtype of
their calls. Parameter names are the measured program's, so the same
seeded weights load into both; nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from perfbench.reference import stylegan as SG
from perfbench.reference.ops import ByteCounter, bias_act, conv2d_resample, upsample2d
from perfbench.reference.steps import (
    GANReference,
    _color,
    _spatial,
)


def low_resolution(resolution: int, num_fp16_res: int) -> int:
    """The lowest resolution of the 16-bit blocks (upstream's
    ``max(2 ** (log2(res) + 1 - num_fp16_res), 8)``; above the image's
    when ``num_fp16_res`` is 0)."""
    return max(2 ** (int(math.log2(resolution)) + 1 - num_fp16_res), 8)


def _round(x, dtype):
    """``x`` through ``dtype`` and back (the control's float8 rounding of
    a block's activations; the cast's backward rounds their gradients
    alike); ``x`` itself where ``dtype`` is None."""
    return x if dtype is None else x.to(dtype).to(x.dtype)


def _clamp(conv_clamp, gain: float = 1.0):
    return None if conv_clamp is None else conv_clamp * gain


def modulated_conv2d(x, w, styles, noise=None, up: int = 1, padding: int = 0,
                     resample_filter=None, demodulate: bool = True, flip_weight: bool = True):
    """As ``ops.modulated_conv2d``, with the styles, weight, demodulation
    and noise taken to the activations' type (float32 styles and
    coefficients)."""
    dcoefs = None
    if demodulate:
        dcoefs = torch.rsqrt(styles.square() @ w.square().sum(dim=(2, 3)).T + 1e-8)
    x = x * styles[:, :, None, None].to(x.dtype)
    x = conv2d_resample(x, w.to(x.dtype), f=resample_filter, up=up, padding=padding,
                        flip_weight=flip_weight)
    if dcoefs is not None:
        x = x * dcoefs[:, :, None, None].to(x.dtype)
    return x if noise is None else x + noise.to(x.dtype)


class SynthesisLayer(SG.SynthesisLayer):
    def __init__(self, cin, cout, w_dim, res, up=1, conv_clamp=None):
        super().__init__(cin, cout, w_dim, res, up=up)
        self.conv_clamp = conv_clamp

    def forward(self, x, w, noise_mode, generator):
        styles = self.affine(w)
        if noise_mode == "random":
            noise = torch.randn((x.shape[0], 1, self.res, self.res), generator=generator,
                                device=x.device) * self.noise_strength
        else:
            noise = self.noise_const[None, None] * self.noise_strength
        x = modulated_conv2d(x, self.weight, styles, noise=noise, up=self.up, padding=1,
                             resample_filter=self.filter, flip_weight=(self.up == 1))
        return bias_act(x, self.bias, act="lrelu", clamp=_clamp(self.conv_clamp))


class ToRGBLayer(SG.ToRGBLayer):
    def __init__(self, cin, cout, w_dim, conv_clamp=None):
        super().__init__(cin, cout, w_dim)
        self.conv_clamp = conv_clamp

    def forward(self, x, w):
        styles = self.affine(w) * self.gain
        x = modulated_conv2d(x, self.weight, styles, demodulate=False)
        return bias_act(x, self.bias, clamp=_clamp(self.conv_clamp))


class SynthesisBlock(SG.SynthesisBlock):
    def __init__(self, cin, cout, w_dim, res, img_channels, conv_clamp=None,
                 dtype=torch.float32, round_dtype=None):
        super().__init__(cin, cout, w_dim, res, img_channels)
        self.dtype, self.round_dtype = dtype, round_dtype
        if cin != 0:
            self.conv0 = SynthesisLayer(cin, cout, w_dim, res, up=2, conv_clamp=conv_clamp)
        self.conv1 = SynthesisLayer(cout, cout, w_dim, res, conv_clamp=conv_clamp)
        self.torgb = ToRGBLayer(cout, img_channels, w_dim, conv_clamp=conv_clamp)

    def forward(self, x, img, ws, noise_mode, generator):
        if self.cin == 0:
            x = _round(self.const[None].expand(ws.shape[0], -1, -1, -1).to(self.dtype),
                       self.round_dtype)
        else:
            x = self.conv0(_round(x.to(self.dtype), self.round_dtype), ws[:, 0], noise_mode,
                           generator)
        x = self.conv1(x, ws[:, self.num_conv - 1], noise_mode, generator)
        if img is not None:
            img = upsample2d(img, self.filter)
        y = self.torgb(x, ws[:, self.num_conv]).float()
        return _round(x, self.round_dtype), (y if img is None else img + y)


class SynthesisNetwork(SG.SynthesisNetwork):
    def __init__(self, w_dim, resolution, img_channels, channel_base, channel_max,
                 conv_clamp=None, num_fp16_res=0, low_dtype=torch.float32, round_dtype=None):
        super().__init__(w_dim, resolution, img_channels, channel_base, channel_max)
        ch = lambda r: min(channel_base // r, channel_max)  # noqa: E731
        low = low_resolution(resolution, num_fp16_res)
        for r in self.resolutions:
            self.add_module(f"b{r}", SynthesisBlock(
                0 if r == 4 else ch(r // 2), ch(r), w_dim, r, img_channels, conv_clamp,
                low_dtype if r >= low else torch.float32, round_dtype))


class Generator(SG.Generator):
    """The original generator with a clamp and 16-bit blocks on request."""

    def __init__(self, z_dim, w_dim, resolution, mapping_layers, channel_base, channel_max,
                 conv_clamp=None, num_fp16_res=0, low_dtype=torch.float32, img_channels=3,
                 round_dtype=None):
        super().__init__(z_dim, w_dim, resolution, mapping_layers, channel_base, channel_max,
                         img_channels)
        self.synthesis = SynthesisNetwork(w_dim, resolution, img_channels, channel_base,
                                          channel_max, conv_clamp, num_fp16_res, low_dtype,
                                          round_dtype)


class Conv2dLayer(SG.Conv2dLayer):
    def __init__(self, cin, cout, k, bias=True, activation="linear", down=1, conv_clamp=None):
        super().__init__(cin, cout, k, bias=bias, activation=activation, down=down)
        self.conv_clamp = conv_clamp

    def forward(self, x, gain: float = 1.0):
        x = conv2d_resample(x, (self.weight * self.gain).to(x.dtype), f=self.filter,
                            down=self.down, padding=self.pad)
        act_gain = (1.0 if self.activation == "linear" else math.sqrt(2.0)) * gain
        return bias_act(x, self.bias, act=self.activation, gain=act_gain,
                        clamp=_clamp(self.conv_clamp, gain))


class DiscriminatorBlock(SG.DiscriminatorBlock):
    def __init__(self, cin, tmp, cout, img_channels, conv_clamp=None, dtype=torch.float32,
                 round_dtype=None):
        super().__init__(cin, tmp, cout, img_channels)
        self.dtype, self.round_dtype = dtype, round_dtype
        if cin == 0:
            self.fromrgb = Conv2dLayer(img_channels, tmp, 1, activation="lrelu",
                                       conv_clamp=conv_clamp)
        self.skip = Conv2dLayer(tmp, cout, 1, bias=False, down=2)
        self.conv0 = Conv2dLayer(tmp, tmp, 3, activation="lrelu", conv_clamp=conv_clamp)
        self.conv1 = Conv2dLayer(tmp, cout, 3, activation="lrelu", down=2, conv_clamp=conv_clamp)

    def forward(self, x, img):
        if self.cin == 0:
            x = self.fromrgb(_round(img.to(self.dtype), self.round_dtype))
        else:
            x = _round(x.to(self.dtype), self.round_dtype)
        y = self.skip(x, gain=math.sqrt(0.5))
        return _round(y + self.conv1(self.conv0(x), gain=math.sqrt(0.5)), self.round_dtype)


class Discriminator(SG.Discriminator):
    def __init__(self, resolution, channel_base, channel_max, mbstd_group, conv_clamp=None,
                 num_fp16_res=0, low_dtype=torch.float32, img_channels=3, round_dtype=None):
        super().__init__(resolution, channel_base, channel_max, mbstd_group, img_channels)
        ch = lambda r: min(channel_base // r, channel_max)  # noqa: E731
        low = low_resolution(resolution, num_fp16_res)
        for i, r in enumerate(self.resolutions):
            self.add_module(f"b{r}", DiscriminatorBlock(
                0 if i == 0 else ch(r), ch(r), ch(r // 2), img_channels, conv_clamp,
                low_dtype if r >= low else torch.float32, round_dtype))
        self.conv = Conv2dLayer(ch(4) + 1, ch(4), 3, activation="lrelu", conv_clamp=conv_clamp)

    def forward(self, img):
        x = None
        for i, r in enumerate(self.resolutions):
            x = getattr(self, f"b{r}")(x, img if i == 0 else None)
        x = self.conv(self.mbstd(x.float()))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.out(self.fc(x))


def factories(s: dict, low_dtype=torch.float32, round_dtype=None) -> dict:
    """The configuration's G and D (``sizes`` of its file), blocks from
    :func:`low_resolution` up in ``low_dtype``, every block's activations
    through ``round_dtype`` at its entry and exit where given."""
    res, cb, cm = s["resolution"], s["channel_base"], s["channel_max"]
    clamp, n16 = s.get("conv_clamp"), s.get("num_fp16_res", 0)
    return {"G": lambda: Generator(s["z_dim"], s["w_dim"], res, s["mapping_layers"], cb, cm,
                                   clamp, n16, low_dtype, round_dtype=round_dtype),
            "D": lambda: Discriminator(res, cb, cm, s["mbstd_group"], clamp, n16, low_dtype,
                                       round_dtype=round_dtype)}


# ------------------------------- ADA, gathered ------------------------------- #


def _lerp(src, pos, dim: int):
    """The bilinear hat sum_s max(0, 1 - |s - pos|) src[.., s, ..] along
    ``dim``: the samples floor(pos) and floor(pos) + 1, weighted 1 - frac
    and frac, none outside the plane. ``pos`` (B, H, W)."""
    n = src.shape[dim]
    lo = torch.floor(pos)
    frac = pos - lo
    out = 0.0
    for at, weight in ((lo, 1.0 - frac), (lo + 1.0, frac)):
        ok = (at >= 0) & (at <= n - 1)
        index = at.clamp(0, n - 1).long()[:, None].expand(-1, src.shape[1], -1, -1)
        out = out + torch.gather(src, dim, index) * (weight * ok)[:, None].to(src.dtype)
    return out


def _warp(images, A, v):
    """``steps.py``'s two passes (along y on the sheared lines, then along x)
    as gathers."""
    B, C, H, W = images.shape
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    a00, a01, a10, a11 = (A[:, i, j, None, None] for i, j in ((0, 0), (0, 1), (1, 0), (1, 1)))
    vx, vy = v[:, 0, None, None], v[:, 1, None, None]
    xs = torch.arange(W, dtype=torch.float32, device=images.device)
    ys = torch.arange(H, dtype=torch.float32, device=images.device)
    syp = ((a10 / a00) * (xs[None, :, None] - cx - vx)
           + ((a00 * a11 - a01 * a10) / a00) * (ys[None, None, :] - cy) + cy + vy)
    tmp = _lerp(images, syp.transpose(1, 2), 2)
    sx = a00 * (xs[None, None, :] - cx) + a01 * (ys[None, :, None] - cy) + cx + vx
    return _lerp(tmp, sx, 3)


def augment(images, p: float, d):
    """``steps.augment`` with the gathered warp."""
    A, v, use_k1, skip = _spatial(d, p, images.shape[2], images.shape[3])
    x = images
    if not bool(skip.all()):
        dev = images.device
        warped = _warp(x, A.to(dev), v.to(dev))
        turned = torch.rot90(warped, 1, dims=(2, 3))
        warped = torch.where(use_k1.to(dev)[:, None, None, None], turned, warped)
        x = torch.where(skip.to(dev)[:, None, None, None], x, warped)
    mats = _color(d, p)
    if bool((mats == torch.eye(4)).all()):
        return x
    xh = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
    return torch.einsum("bjhw,bij->bihw", xh, mats.to(x.device))[:, :3]


# --------------------------------- the step ---------------------------------- #


class GANReferenceMP(GANReference):
    """``steps.GANReference`` with the gathered ADA pipe and the path length
    on the first ``batch // pl_batch_shrink`` rows of each card's share
    (stylegan2-ada-pytorch's ``pl_batch_shrink``)."""

    def __init__(self, G, D, g_ema, h, ada_p: float, ranks: int = 1, pl_batch_shrink: int = 1):
        super().__init__(G, D, g_ema, h, ada_p, ranks)
        self.shrink = pl_batch_shrink

    def _d(self, images, draws):
        return self.D(augment(images, self.ada_p, draws))

    def step(self, images_u8, d, count=None):
        if d.zp is not None and self.shrink > 1:
            local = d.zp.shape[0] // self.ranks
            keep = torch.cat([torch.arange(r * local, r * local + max(1, local // self.shrink))
                              for r in range(self.ranks)]).to(d.zp.device)
            d = dataclasses.replace(d, zp=d.zp[keep], pl_y=d.pl_y[keep])
        return super().step(images_u8, d, count)


# --------------------------------- counting ---------------------------------- #


class MixedCount:
    """``with MixedCount() as c``: ``c.flops`` the FLOPs of every operation
    dispatched in the block by the dtype of its first tensor input ("16bit"
    or "fp32"; ``torch.utils.flop_counter``'s formulas), ``c.bytes`` the
    kernels' bytes as ``ops.ByteCounter`` counts them (at each tensor's own
    element size)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                formula = flop_registry.get(func._overloadpacket)
                if formula is not None:
                    first = next((a for a in args if isinstance(a, torch.Tensor)), None)
                    key = "16bit" if first is not None and first.element_size() == 2 else "fp32"
                    counter.flops[key] += formula(*args, **kwargs, out_val=out)
                return out

        self.flops = {"16bit": 0, "fp32": 0}
        self._mode = _Mode()
        self._bytes = ByteCounter()

    @property
    def bytes(self) -> dict:
        return dict(self._bytes.bytes)

    def __enter__(self):
        self._bytes.__enter__()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._bytes.__exit__(*exc)
        return False
