"""Image transforms: host geometry (numpy/PIL) and on-device preprocess.

Counterpart of ``viscoin_tpu/data/transforms.py``. The host resizes and
crops to a fixed-size uint8 HWC image (the only shape-dynamic work); the
device turns the uint8 NHWC batch into a normalized float32 NCHW batch.
Test geometry follows torchvision: Resize(short side = size / 0.875) +
CenterCrop(size).
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

TRAIN_SIZE = 256
TEST_RESIZE = int(256 / 0.875)  # 292


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


def _stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)[:, None, None]
    return mean, std


def device_preprocess(images_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8, on the device that should compute -> normalized
    float32 (B, 3, H, W). (The training flip arrives with the training slice.)"""
    x = images_u8.permute(0, 3, 1, 2).float() / 255.0
    mean, std = _stats(x)
    return (x - mean) / std


def denormalize(x: torch.Tensor) -> torch.Tensor:
    """Invert the ImageNet normalization of an NCHW batch."""
    mean, std = _stats(x)
    return x * std + mean
