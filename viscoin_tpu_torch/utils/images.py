"""Image display and conversion: a copy of ``viscoin_tpu/utils/images.py``
(plain numpy), with the reference's ``from_torch``, which takes NCHW or NHWC
and gives display-ready HWC."""

from __future__ import annotations

import numpy as np


def normalize_image(x: np.ndarray) -> np.ndarray:
    """Min-max normalize for display: floats to [0, 1], integers to uint8."""
    x = np.asarray(x)
    mn, mx = x.min(), x.max()
    if np.issubdtype(x.dtype, np.floating):
        return (x - mn) / max(mx - mn, 1e-12)
    return (((x.astype(np.float32) - mn) / max(mx - mn, 1e-12)) * 255).astype(np.uint8)


def clip_image(x: np.ndarray) -> np.ndarray:
    """Clip for display: floats to [0, 1], integers to [0, 255]."""
    x = np.asarray(x)
    if np.issubdtype(x.dtype, np.floating):
        return np.clip(x, 0, 1)
    return np.clip(x, 0, 255)


def from_torch(x) -> np.ndarray:
    """An image or a batch (a tensor or an array; NCHW, CHW, NHWC or HWC with
    3 channels) -> display-ready channels-last numpy, min-max normalized over
    the whole input; a batch of one loses its batch dim."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    x = np.asarray(x)
    if x.shape[-1] != 3 and x.shape[-3] == 3:  # channels first
        x = np.moveaxis(x, -3, -1)
    x = normalize_image(x)
    if x.ndim == 4 and x.shape[0] == 1:
        return x[0]
    return x


def heatmap_to_img(heatmap: np.ndarray, size: int = 256) -> np.ndarray:
    """Heatmap -> RGB uint8 (JET colormap, resized to ``size``²): cv2 where
    it is installed, else matplotlib's jet (``utils/colormaps.py``) and a
    PIL bicubic resize."""
    heatmap = np.asarray(heatmap).squeeze()
    try:
        import cv2

        norm = cv2.normalize(heatmap, None, 0, 255, cv2.NORM_MINMAX).astype(np.uint8)
        colored = cv2.applyColorMap(norm, cv2.COLORMAP_JET)
        resized = cv2.resize(colored, (size, size), interpolation=cv2.INTER_CUBIC)
        return cv2.cvtColor(resized, cv2.COLOR_BGR2RGB)
    except ImportError:
        from PIL import Image

        from viscoin_tpu_torch.utils.colormaps import JET, lookup

        norm = normalize_image(heatmap.astype(np.float32))
        rgb = (lookup(JET, norm)[..., :3] * 255).astype(np.uint8)
        return np.asarray(Image.fromarray(rgb).resize((size, size), Image.BICUBIC))


def overlay(image: np.ndarray, over: np.ndarray, alpha: float = 0.4) -> np.ndarray:
    """Alpha-blend ``over`` onto ``image`` (same dtype)."""
    if image.dtype != over.dtype:
        raise ValueError(f"image and overlay must have the same dtype, got {image.dtype} and "
                         f"{over.dtype}")
    out = image.astype(np.float32) * (1 - alpha) + over.astype(np.float32) * alpha
    return out.astype(image.dtype)
