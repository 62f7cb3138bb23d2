"""FID statistics: streaming mean and covariance, the Fréchet distance,
KID and improved precision and recall.

Counterpart of ``viscoin_tpu/eval/fid.py``; the detector that gives the
features is ``models/inception.py``. The moments accumulate in float64 on
the host and the matrix square root is scipy's. ``capture_all`` keeps the
feature rows too, which KID and precision/recall work on.
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


def kernel_inception_distance(real: np.ndarray, fake: np.ndarray, num_subsets: int = 100,
                              max_subset_size: int = 1000, seed: int = 0) -> float:
    """KID: the unbiased MMD² with the cubic polynomial kernel
    k(x, y) = (x·y / d + 1)³, averaged over ``num_subsets`` subsets (without
    replacement) of size min(len(real), len(fake), max_subset_size), drawn
    by numpy's generator from ``seed``. Can be slightly negative."""
    real = np.asarray(real, np.float64)
    fake = np.asarray(fake, np.float64)
    if real.ndim != 2 or fake.ndim != 2 or real.shape[1] != fake.shape[1]:
        raise ValueError(f"features must be (N, D) with one D, got {real.shape}, {fake.shape}")
    d = real.shape[1]
    m = min(real.shape[0], fake.shape[0], max_subset_size)
    if m < 2:
        raise ValueError(f"KID needs at least 2 samples per side, got {m}")
    rng = np.random.default_rng(seed)
    total = 0.0
    for _ in range(num_subsets):
        x = fake[rng.choice(fake.shape[0], m, replace=False)]
        y = real[rng.choice(real.shape[0], m, replace=False)]
        kxx = (x @ x.T / d + 1.0) ** 3
        kyy = (y @ y.T / d + 1.0) ** 3
        kxy = (x @ y.T / d + 1.0) ** 3
        # Unbiased: the within-set sums leave the diagonal out.
        total += ((kxx.sum() - np.trace(kxx)) / (m - 1) + (kyy.sum() - np.trace(kyy)) / (m - 1)
                  - 2.0 * kxy.sum() / m)
    return float(total / num_subsets / m)


def kid_from_stats(stats_real: FeatureStats, stats_fake: FeatureStats, num_subsets: int = 100,
                   max_subset_size: int = 1000, seed: int = 0) -> float:
    return kernel_inception_distance(stats_real.get_all(), stats_fake.get_all(), num_subsets,
                                     max_subset_size, seed)


def precision_recall(real: np.ndarray, fake: np.ndarray, nhood_size: int = 3,
                     row_batch: int = 4096) -> tuple[float, float]:
    """Improved precision and recall (Kynkäänniemi et al. 2019, the
    stylegan2-ada pr50k3 metric): each side's manifold is the union of balls
    around its samples whose radius is the ``nhood_size``-th nearest
    neighbour's distance within the side; precision is the share of fakes
    inside the real manifold, recall the share of reals inside the fake one.
    Squared L2 distances in float32, ``row_batch`` rows at a time."""
    real = np.asarray(real, np.float32)
    fake = np.asarray(fake, np.float32)
    if real.ndim != 2 or fake.ndim != 2 or real.shape[1] != fake.shape[1]:
        raise ValueError(f"features must be (N, D) with one D, got {real.shape}, {fake.shape}")
    if min(real.shape[0], fake.shape[0]) <= nhood_size:
        raise ValueError(f"precision/recall needs more than nhood_size={nhood_size} samples per "
                         f"side, got {real.shape[0]} real / {fake.shape[0]} fake")

    def sq_dists(a, b):
        d2 = np.sum(a * a, axis=1)[:, None] + np.sum(b * b, axis=1)[None, :] - 2.0 * (a @ b.T)
        return np.maximum(d2, 0.0)

    def radii(x):  # the (nhood_size + 1)-th smallest distance: the sample itself is at 0
        out = np.empty(x.shape[0], np.float32)
        for s in range(0, x.shape[0], row_batch):
            out[s: s + row_batch] = np.partition(sq_dists(x[s: s + row_batch], x), nhood_size,
                                                 axis=1)[:, nhood_size]
        return out

    def fraction_inside(probes, manifold, manifold_r2):
        hits = 0
        for s in range(0, probes.shape[0], row_batch):
            d2 = sq_dists(probes[s: s + row_batch], manifold)
            hits += int(np.any(d2 <= manifold_r2[None, :], axis=1).sum())
        return hits / probes.shape[0]

    precision = fraction_inside(fake, real, radii(real))
    recall = fraction_inside(real, fake, radii(fake))
    return float(precision), float(recall)


def pr_from_stats(stats_real: FeatureStats, stats_fake: FeatureStats,
                  nhood_size: int = 3) -> tuple[float, float]:
    return precision_recall(stats_real.get_all(), stats_fake.get_all(), nhood_size)
