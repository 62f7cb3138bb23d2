"""Whole-dataset latent spaces with disk caches.

Counterpart of ``viscoin_tpu/eval/spaces.py``: Phi (``compute_concept_space``)
or the adapted generator's W+ (``compute_w_space``) over both splits, in
fixed batches (a short last batch padded by ``data/loader.py::pad_batch``,
its padded rows dropped), cached as ``{cache_dir}/{dataset_key}.npz`` with
the JAX package's keys (``train``, ``test``), layouts (Phi NHWC
(N, 3, 3, K), W+ (N, num_ws, w_dim)) and file names, so either package
reads the other's caches.

The W+ pass runs f, Psi and the adapted mapping only: the JAX package calls
the whole generator and drops the image, which XLA then deletes; the port
never runs the synthesis, so it launches ``bias_act`` (the mapping's) and
no ``upfirdn2d``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from viscoin_tpu_torch.data.loader import pad_batch
from viscoin_tpu_torch.data.transforms import device_preprocess
from viscoin_tpu_torch.eval.viscoin import _placement, to_device
from viscoin_tpu_torch.models.bundle import VisCoINModels

SPACES_BATCH_SIZE = 32


def make_space_fn(models: VisCoINModels, what: str):
    """``images_u8 (B, H, W, 3) -> `` Phi NHWC (``what`` = "concepts") or W+
    (``what`` = "w"), fp32, on the bundle's device."""
    if what not in ("concepts", "w"):
        raise ValueError(f"what must be 'concepts' or 'w', got {what!r}")

    @torch.no_grad()
    def fwd(images_u8: torch.Tensor) -> torch.Tensor:
        _, dtype = _placement(models)
        x = device_preprocess(images_u8).to(dtype)
        _, hidden = models.classifier(x)
        phi, phi_prime = models.concept_extractor(tuple(hidden[-3:]))
        if what == "concepts":
            return phi.float().permute(0, 2, 3, 1)
        return models.gan.mapping(phi, phi_prime).float()

    return fwd


def run_over(models: VisCoINModels, dataset, batch_size: int, what: str) -> np.ndarray:
    """``make_space_fn`` over every image of ``dataset``, in order."""
    device, _ = _placement(models)
    fwd = make_space_fn(models, what)
    out = []
    n = len(dataset)
    for s in range(0, n, batch_size):
        idx = range(s, min(s + batch_size, n))
        images, _ = pad_batch(batch_size, np.stack([dataset[i][0] for i in idx]))
        out.append(fwd(to_device(images, device)).cpu().numpy()[: len(idx)])
    return np.concatenate(out, axis=0)


def _cache_path(cache_dir: str, dataset_name: str, train_ds) -> str:
    """``{cache_dir}/{dataset_key}.npz``; a decode size other than 256 joins
    the key (the arrays' shapes do not depend on it, so a stale 256² cache
    would otherwise satisfy another size's run)."""
    from viscoin_tpu_torch.data.utils import dataset_key

    key = dataset_key(dataset_name)
    size = getattr(train_ds, "out_size", 256)
    if size != 256:
        key = f"{key}_{size}"
    return os.path.join(cache_dir, f"{key}.npz")


def _cached_space(what: str, models, dataset_name, train_ds, test_ds, batch_size, cache_dir):
    cache = _cache_path(cache_dir, dataset_name, train_ds)
    if os.path.exists(cache):
        with np.load(cache) as data:
            return data["train"], data["test"]
    train = run_over(models, train_ds, batch_size, what)
    test = run_over(models, test_ds, batch_size, what)
    os.makedirs(cache_dir, exist_ok=True)
    np.savez(cache, train=train, test=test)
    return train, test


def compute_concept_space(models: VisCoINModels, dataset_name: str, train_ds, test_ds,
                          batch_size: int = SPACES_BATCH_SIZE,
                          cache_dir: str = "checkpoints/concepts"):
    """Phi over both splits, cached: NHWC (N, 3, 3, K) arrays (train, test)."""
    return _cached_space("concepts", models, dataset_name, train_ds, test_ds, batch_size,
                         cache_dir)


def compute_w_space(models: VisCoINModels, dataset_name: str, train_ds, test_ds,
                    batch_size: int = SPACES_BATCH_SIZE, cache_dir: str = "checkpoints/gan-w"):
    """W+ over both splits, cached: (N, num_ws, w_dim) arrays (train, test)."""
    return _cached_space("w", models, dataset_name, train_ds, test_ds, batch_size, cache_dir)
