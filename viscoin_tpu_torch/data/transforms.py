"""Image transforms: host geometry (numpy/PIL) and on-device preprocess.

Counterpart of ``viscoin_tpu/data/transforms.py``. The host resizes and
crops to a fixed-size uint8 HWC image (the only shape-dynamic work); the
device turns the uint8 NHWC batch into a normalized float32 NCHW batch.
Geometry follows torchvision:

  * train: RandomResizedCrop(size, scale=(0.08, 1.0), ratio=(3/4, 4/3)); the
    horizontal flip is decided on the device;
  * test: Resize(short side = size / 0.875) + CenterCrop(size);
  * gan: short side resized to ``size`` + center crop (the StyleGAN2-ADA
    dataset tool's geometry).
"""

from __future__ import annotations

import math

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

TRAIN_SIZE = 256
TEST_RESIZE = int(256 / 0.875)  # 292
_CHANNEL_CONSTANTS: dict[tuple, torch.Tensor] = {}


def random_resized_crop_params(height: int, width: int, rng: np.random.Generator,
                               scale: tuple[float, float] = (0.08, 1.0),
                               ratio: tuple[float, float] = (3 / 4, 4 / 3)
                               ) -> tuple[int, int, int, int]:
    """torchvision's RandomResizedCrop.get_params: (top, left, h, w)."""
    area = height * width
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            top = int(rng.integers(0, height - h + 1))
            left = int(rng.integers(0, width - w + 1))
            return top, left, h, w
    # Fallback: a center crop with the aspect clamped to the ratio range.
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w = width
        h = int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        h = height
        w = int(round(h * ratio[1]))
    else:
        w, h = width, height
    return (height - h) // 2, (width - w) // 2, h, w


def host_train_transform(img: np.ndarray, rng: np.random.Generator,
                         size: int = TRAIN_SIZE) -> np.ndarray:
    """RandomResizedCrop to (size, size) uint8 HWC (the flip happens on the device)."""
    from PIL import Image

    h, w = img.shape[:2]
    top, left, ch, cw = random_resized_crop_params(h, w, rng)
    crop = img[top: top + ch, left: left + cw]
    return np.asarray(Image.fromarray(crop).resize((size, size), Image.BILINEAR), np.uint8)


def host_gan_transform(img: np.ndarray, size: int = TRAIN_SIZE) -> np.ndarray:
    """Short side resized to ``size`` + center crop: for a square input,
    exactly Resize((size, size))."""
    return host_test_transform(img, size=size, resize_to=size)


def host_test_transform(img: np.ndarray, size: int = TRAIN_SIZE,
                        resize_to: int = TEST_RESIZE) -> np.ndarray:
    """Resize(short side) + CenterCrop to (size, size) uint8 HWC."""
    from PIL import Image

    h, w = img.shape[:2]
    if h < w:
        nh, nw = resize_to, max(1, int(round(w * resize_to / h)))
    else:
        nh, nw = max(1, int(round(h * resize_to / w))), resize_to
    out = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR), np.uint8)
    top = (nh - size) // 2
    left = (nw - size) // 2
    # torchvision CenterCrop pads if the image is smaller than the crop
    if top < 0 or left < 0:
        pad_h, pad_w = max(-top, 0), max(-left, 0)
        out = np.pad(out, ((pad_h, pad_h), (pad_w, pad_w), (0, 0)))
        top, left = max(top, 0), max(left, 0)
    return out[top: top + size, left: left + size]


def channel_constant(values: tuple[float, ...], like: torch.Tensor) -> torch.Tensor:
    """``values`` as a (C, 1, 1) tensor of ``like``'s device and dtype, made
    once per (values, device, dtype): a copy to the card per call waits for
    the stream, and a CUDA graph cannot capture it. Made outside inference
    mode, so that a constant first made while serving can enter autograd
    later. While a program is traced for ``torch.export`` it is made afresh
    and not kept: a tensor of the tracer's must not outlive its trace."""
    if torch.compiler.is_exporting():
        return torch.tensor(values, dtype=like.dtype, device=like.device)[:, None, None]
    key = (values, like.device, like.dtype)
    c = _CHANNEL_CONSTANTS.get(key)
    if c is None:
        with torch.inference_mode(False):
            c = _CHANNEL_CONSTANTS[key] = torch.tensor(values, dtype=like.dtype,
                                                       device=like.device)[:, None, None]
    return c


def _stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return channel_constant(IMAGENET_MEAN, x), channel_constant(IMAGENET_STD, x)


def device_preprocess(images_u8: torch.Tensor, flip: torch.Tensor | None = None) -> torch.Tensor:
    """(B, H, W, 3) uint8, on the device that should compute -> normalized
    float32 (B, 3, H, W). ``flip``: optional (B,) bool, a horizontal flip per
    sample (training)."""
    x = images_u8.permute(0, 3, 1, 2).float() / 255.0
    if flip is not None:
        x = torch.where(flip.to(x.device)[:, None, None, None], x.flip(3), x)
    mean, std = _stats(x)
    return (x - mean) / std


def normalize_only(x: torch.Tensor) -> torch.Tensor:
    """The ImageNet normalization of an NCHW batch in [0, 1]."""
    mean, std = _stats(x)
    return (x - mean) / std


def denormalize(x: torch.Tensor) -> torch.Tensor:
    """Invert the ImageNet normalization of an NCHW batch."""
    mean, std = _stats(x)
    return x * std + mean
