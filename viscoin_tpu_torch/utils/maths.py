"""Math utilities: a copy of ``viscoin_tpu/utils/maths.py`` (plain numpy)."""

from __future__ import annotations

import numpy as np


def normalize(arr: np.ndarray, axis: int | None = None) -> np.ndarray:
    """Min-max normalize to [0, 1], over the whole array or along ``axis``.
    A constant slice maps to 0, not NaN."""
    mn = arr.min(axis=axis, keepdims=True)
    mx = arr.max(axis=axis, keepdims=True)
    rng = mx - mn
    rng = np.where(rng == 0, 1, rng)
    return (arr - mn) / rng
