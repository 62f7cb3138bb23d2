"""InceptionV3 feature extractor for FID, NCHW.

Counterpart of ``viscoin_tpu/models/inception.py``: the torchvision
InceptionV3 layout with pytorch-fid's pooling conventions (the average pools
leave the padding out of the count; Mixed_7c pools its branch with a max
pool), returning the 2048-d pooled features. BatchNorm (eps 1e-3) always
uses its running statistics. Submodule names follow the JAX modules
(``Mixed_5b.branch1x1.conv`` ...), so a JAX-layout tree loads through
``utils/weights.py::load_jax_tree``.

Two preprocessing conventions, as in the JAX package:

  * :func:`fid_preprocess` (ported pytorch-fid / torchvision weights): the
    ImageNet-normalized batch back to [0, 1], resized to 299² as
    ``jax.image.resize(..., "bilinear")`` resizes (half-pixel centres, the
    weights renormalised at the border, antialiased when shrinking), then
    scaled to [-1, 1];
  * :func:`nvlabs_fid_preprocess` (weights ported from the NVlabs TorchScript
    detector): the batch as the reference feeds that detector, resized to
    299² by the TF1 convention (:func:`tf1_resize_bilinear`), then
    (x - 128) / 128.

:func:`make_torchscript_fid_detector` runs the NVlabs TorchScript file
itself, on the caller's device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from viscoin_tpu_torch.data.transforms import denormalize

FID_IMAGE_SIZE = 299


class BasicConv(nn.Module):
    """Conv (no bias) + BatchNorm (eps 1e-3, running statistics) + ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel, stride: int = 1,
                 padding=(0, 0), device="cuda"):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel, stride=stride, padding=padding,
                              bias=False, device=device)
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-3, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn
        x = F.batch_norm(self.conv(x), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         training=False, eps=bn.eps)
        return torch.relu(x)


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, device="cuda"):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 64, 1, device=device)
        self.branch5x5_1 = BasicConv(cin, 48, 1, device=device)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=(2, 2), device=device)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1, device=device)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=(1, 1), device=device)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=(1, 1), device=device)
        self.branch_pool = BasicConv(cin, pool_features, 1, device=device)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int, device="cuda"):
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, 3, stride=2, device=device)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1, device=device)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=(1, 1), device=device)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2, device=device)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, device="cuda"):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 192, 1, device=device)
        self.branch7x7_1 = BasicConv(cin, c7, 1, device=device)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3), device=device)
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0), device=device)
        self.branch7x7dbl_1 = BasicConv(cin, c7, 1, device=device)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0), device=device)
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3), device=device)
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0), device=device)
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3), device=device)
        self.branch_pool = BasicConv(cin, 192, 1, device=device)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int, device="cuda"):
        super().__init__()
        self.branch3x3_1 = BasicConv(cin, 192, 1, device=device)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2, device=device)
        self.branch7x7x3_1 = BasicConv(cin, 192, 1, device=device)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3), device=device)
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0), device=device)
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2, device=device)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(nn.Module):
    """``max_pool``: Mixed_7c's branch pool is a max pool (pytorch-fid's
    FIDInceptionE_2, the TF-slim graph's semantics); Mixed_7b's an average."""

    def __init__(self, cin: int, max_pool: bool = False, device="cuda"):
        super().__init__()
        self.max_pool = max_pool
        self.branch1x1 = BasicConv(cin, 320, 1, device=device)
        self.branch3x3_1 = BasicConv(cin, 384, 1, device=device)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1), device=device)
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0), device=device)
        self.branch3x3dbl_1 = BasicConv(cin, 448, 1, device=device)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=(1, 1), device=device)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1), device=device)
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0), device=device)
        self.branch_pool = BasicConv(cin, 192, 1, device=device)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = F.max_pool2d(x, 3, stride=1, padding=1) if self.max_pool else _avg_pool(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], dim=1)


class InceptionV3Features(nn.Module):
    """(B, 3, 299, 299) in [-1, 1] -> (B, 2048) pooled features."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2, device=device)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3, device=device)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=(1, 1), device=device)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1, device=device)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3, device=device)
        self.Mixed_5b = InceptionA(192, 32, device=device)
        self.Mixed_5c = InceptionA(256, 64, device=device)
        self.Mixed_5d = InceptionA(288, 64, device=device)
        self.Mixed_6a = InceptionB(288, device=device)
        self.Mixed_6b = InceptionC(768, 128, device=device)
        self.Mixed_6c = InceptionC(768, 160, device=device)
        self.Mixed_6d = InceptionC(768, 160, device=device)
        self.Mixed_6e = InceptionC(768, 192, device=device)
        self.Mixed_7a = InceptionD(768, device=device)
        self.Mixed_7b = InceptionE(1280, device=device)
        self.Mixed_7c = InceptionE(2048, max_pool=True, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


# ------------------------------ preprocessing ------------------------------- #


@functools.lru_cache(maxsize=16)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of ``jax.image.resize``'s bilinear (triangle)
    kernel: half-pixel centres; the kernel widened by n_in / n_out when
    shrinking (antialiasing); each output's weights divided by their sum;
    an output whose centre falls outside the input gets none. In float32,
    op for op as JAX computes them (the scale's inverse in double first)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0).astype(f32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


_RESIZE_MATRICES: dict[tuple, torch.Tensor] = {}


def _resize_weights(n_in: int, n_out: int, like: torch.Tensor) -> torch.Tensor:
    """:func:`_resize_matrix` on ``like``'s device and dtype, made once (and
    outside inference mode, so that it may enter autograd later)."""
    key = (n_in, n_out, like.device, like.dtype)
    if key not in _RESIZE_MATRICES:
        with torch.inference_mode(False):
            _RESIZE_MATRICES[key] = torch.from_numpy(_resize_matrix(n_in, n_out)).to(
                like.device, like.dtype)
    return _RESIZE_MATRICES[key]


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """``jax.image.resize(x, (.., size, size, ..), "bilinear")`` of an NCHW
    batch: a contraction with the weights of :func:`_resize_matrix` over H,
    then one over W."""
    mh = _resize_weights(x.shape[2], size, x)
    mw = _resize_weights(x.shape[3], size, x)
    x = torch.einsum("bchw,hy->bcyw", x, mh)
    return torch.einsum("bcyw,wx->bcyx", x, mw)


def fid_preprocess(x: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalized float NCHW images -> 299² in [-1, 1]."""
    x = denormalize(x.float()).clamp(0.0, 1.0)
    if x.shape[2:] != (FID_IMAGE_SIZE, FID_IMAGE_SIZE):
        x = resize_bilinear(x, FID_IMAGE_SIZE)
    return x * 2.0 - 1.0


def tf1_resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """TF1's ``resize_bilinear`` (align_corners=False, half_pixel_centers=
    False) of an NCHW batch: source coordinate dst * (in / out), no
    half-pixel shift, no antialiasing (the NVlabs detector's resize)."""
    H, W = x.shape[2], x.shape[3]
    if (H, W) == (size, size):
        return x

    def axis(n_in: int):
        src = torch.arange(size, dtype=torch.float32, device=x.device) * (n_in / size)
        lo = src.floor().long().clamp(0, n_in - 1)
        hi = (lo + 1).clamp(max=n_in - 1)
        return lo, hi, (src - lo.float()).to(x.dtype)

    ylo, yhi, wy = axis(H)
    xlo, xhi, wx = axis(W)
    wy, wx = wy[:, None], wx
    top = x[:, :, ylo] * (1 - wy) + x[:, :, yhi] * wy
    return top[:, :, :, xlo] * (1 - wx) + top[:, :, :, xhi] * wx


def nvlabs_fid_preprocess(x: torch.Tensor) -> torch.Tensor:
    """The NVlabs detector's own preprocessing of what the reference feeds
    it (the normalized floats, not rescaled): TF1 resize to 299², then
    (x - 128) / 128."""
    return (tf1_resize_bilinear(x.float(), FID_IMAGE_SIZE) - 128.0) / 128.0


# -------------------------------- detectors --------------------------------- #


def inception_from_tree(variables: dict, device="cuda") -> InceptionV3Features:
    """An ``InceptionV3Features`` on ``device`` holding ``variables`` (JAX
    layout, {params, batch_stats})."""
    from viscoin_tpu_torch.utils.weights import load_jax_tree

    model = InceptionV3Features(device=device)
    return load_jax_tree(model, {"params": variables["params"],
                                 "batch_stats": variables["batch_stats"]}).eval()


def _detector(model: InceptionV3Features, preprocess):
    @torch.no_grad()
    def detect(images: torch.Tensor) -> torch.Tensor:
        return model(preprocess(images))

    return detect


def make_fid_detector(variables: dict, device="cuda"):
    """(float NCHW images, ImageNet-normalized) -> (B, 2048) features on the
    images' device, for pytorch-fid / torchvision weights."""
    return _detector(inception_from_tree(variables, device), fid_preprocess)


def make_nvlabs_fid_detector(variables: dict, device="cuda"):
    """The same for weights ported from the NVlabs TorchScript detector
    (``port-weights inception-nvlabs``): the reference's FID convention."""
    return _detector(inception_from_tree(variables, device), nvlabs_fid_preprocess)


def run_torchscript(module, x: torch.Tensor) -> torch.Tensor:
    """The NVlabs TorchScript detector's features of an NCHW batch (fabricated
    exports may lack the ``return_features`` argument)."""
    try:
        return module(x, return_features=True)
    except (TypeError, RuntimeError):
        return module(x)


def make_torchscript_fid_detector(path: str, device="cuda"):
    """The NVlabs TorchScript detector itself (``torch.jit.load`` of the
    local file onto ``device``), fed as the reference feeds it: the
    normalized NCHW batch, untouched. Its numbers are the reference's FID."""
    module = torch.jit.load(path, map_location=device).eval()

    @torch.no_grad()
    def detect(images: torch.Tensor) -> torch.Tensor:
        return run_torchscript(module, images.float())

    return detect
