"""FID statistics: streaming mean and covariance, and the Fréchet distance.

Counterpart of ``viscoin_tpu/eval/fid.py`` (the statistics only; the
Inception detector is not ported yet). The moments accumulate in float64
on the host and the matrix square root is scipy's.
"""

from __future__ import annotations

import numpy as np


class FeatureStats:
    """Streaming mean + covariance of feature rows."""

    def __init__(self, max_items: int | None = None, capture_all: bool = False):
        self.max_items = max_items
        self.num_items = 0
        self._sum = None
        self._outer = None
        self._all: list[np.ndarray] | None = [] if capture_all else None

    def append(self, features: np.ndarray) -> None:
        x = np.asarray(features, np.float64)
        if x.ndim != 2:
            raise ValueError(f"features must be (N, D), got {x.shape}")
        if self.max_items is not None:
            remaining = self.max_items - self.num_items
            if remaining <= 0:
                return
            x = x[:remaining]
        if self._sum is None:
            self._sum = np.zeros(x.shape[1])
            self._outer = np.zeros((x.shape[1], x.shape[1]))
        self.num_items += x.shape[0]
        self._sum += x.sum(axis=0)
        self._outer += x.T @ x
        if self._all is not None:
            self._all.append(x)

    def get_all(self) -> np.ndarray:
        if self._all is None:
            raise ValueError("FeatureStats was not built with capture_all")
        return np.concatenate(self._all, axis=0)

    def append_moments(self, sum_x: np.ndarray, outer: np.ndarray, n: float) -> None:
        """Accumulate precomputed moments (sum x, sum x x^T, count)."""
        sum_x = np.asarray(sum_x, np.float64)
        outer = np.asarray(outer, np.float64)
        if self.max_items is not None and self.num_items + n > self.max_items:
            raise ValueError("append_moments cannot truncate to max_items")
        if self._sum is None:
            self._sum = np.zeros(sum_x.shape[0])
            self._outer = np.zeros(outer.shape)
        self.num_items += int(n)
        self._sum += sum_x
        self._outer += outer

    def get_mean_cov(self) -> tuple[np.ndarray, np.ndarray]:
        mean = self._sum / self.num_items
        return mean, self._outer / self.num_items - np.outer(mean, mean)


def frechet_distance(mu_real, sigma_real, mu_fake, sigma_fake) -> float:
    """The Fréchet distance between two Gaussians."""
    from scipy.linalg import sqrtm

    m = np.square(mu_fake - mu_real).sum()
    s = sqrtm(np.dot(sigma_fake, sigma_real))
    if isinstance(s, tuple):  # older scipy returns (sqrtm, errest)
        s = s[0]
    return float(np.real(m + np.trace(sigma_fake + sigma_real - s * 2)))


def fid_from_stats(stats_real: FeatureStats, stats_fake: FeatureStats) -> float:
    mu_r, sig_r = stats_real.get_mean_cov()
    mu_f, sig_f = stats_fake.get_mean_cov()
    return frechet_distance(mu_r, sig_r, mu_f, sig_f)
