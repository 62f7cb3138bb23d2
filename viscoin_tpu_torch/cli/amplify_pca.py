"""The ``amplify-pca`` command: amplify a test image along W+ PCA components.

Counterpart of ``viscoin_tpu/cli/amplify_pca.py``, with its options, plus
``--device`` (the card by default) and ``--outdir``, where the figures go
(``amplify_pca_{i}.png``, five components each; the JAX command shows them):

    python -m viscoin_tpu_torch amplify-pca --dataset synthetic --pca 10

W+ over the training set comes from ``eval/spaces.py::compute_w_space``
(cached under ``checkpoints/gan-w``); the PCA is numpy's SVD of the centred,
flattened W+ on the host (sklearn's components); each component's
``len(MULTIPLIERS)`` images are one ``gen_from_w`` call (const noise, under
cuDNN's deterministic algorithms). Without ``--image`` the image is drawn
from numpy's global generator, as in the JAX command.
"""

from __future__ import annotations

import argparse

import numpy as np

from viscoin_tpu_torch.cli.utils import (
    add_dataset_option,
    add_device_option,
    add_outdir_option,
    add_viscoin_pickle_option,
)

MULTIPLIERS = (0, 1, 5, 10, 15)


def add_parser(subparsers) -> None:
    p = subparsers.add_parser("amplify-pca", help="Amplify a random test image using PCA "
                                                  "directions of the W+ space.")
    add_dataset_option(p)
    add_device_option(p)
    add_viscoin_pickle_option(p)
    p.add_argument("--pca", type=int, default=10, help="Amount of PCA components to compute")
    p.add_argument("--image", type=int, default=None,
                   help="Index of the test image to amplify (random if omitted)")
    add_outdir_option(p)
    p.set_defaults(func=amplify_pca)


def pca_components(train_w: np.ndarray, n: int) -> np.ndarray:
    """The first ``n`` principal directions of W+ (N, num_ws, w_dim), as
    (n, num_ws, w_dim) fp32."""
    flat = train_w.reshape(train_w.shape[0], -1).astype(np.float64)
    _, _, vt = np.linalg.svd(flat - flat.mean(axis=0), full_matrices=False)
    return vt[:n].reshape(n, *train_w.shape[1:]).astype(np.float32)


def pca_images(models, latent: np.ndarray, components: np.ndarray,
               multipliers=MULTIPLIERS) -> np.ndarray:
    """(n_components, len(multipliers), H, W, 3) display images of
    ``latent`` (num_ws, w_dim) moved along each component by each
    multiplier; one ``gen_from_w`` call per component, each normalized for
    display over its row (as the JAX command)."""
    import torch

    from viscoin_tpu_torch.utils.cudnn import deterministic_cudnn
    from viscoin_tpu_torch.utils.images import from_torch

    p = next(models.parameters())
    factors = np.asarray(multipliers, np.float32).reshape(1, len(multipliers), 1, 1)
    amplified = latent[None, None] + components[:, None] * factors  # (n, M, num_ws, w_dim)
    size = models.gan.img_resolution
    images = np.zeros((len(components), len(multipliers), size, size, 3))
    for i in range(len(components)):
        w = torch.from_numpy(amplified[i]).to(p.device, p.dtype)
        with torch.no_grad(), deterministic_cudnn():
            imgs = models.gan.gen_from_w(w, noise_mode="const")
        images[i] = from_torch(imgs)
    return images


def w_plus_pca(models, dataset: str, n_components: int, image: int | None):
    """The command's computation: (the image's index, ``pca_images`` of its
    W+ along the first ``n_components`` directions)."""
    from viscoin_tpu_torch.data.utils import get_datasets
    from viscoin_tpu_torch.eval.spaces import compute_w_space

    train_ds, test_ds = get_datasets(dataset, "test")
    train_w, test_w = compute_w_space(models, dataset, train_ds, test_ds)
    components = pca_components(train_w, n_components)
    index = int(np.random.randint(0, len(test_ds))) if image is None else image
    print("Amplifying image n°", index)
    return index, pca_images(models, test_w[index], components)


def amplify_pca(args: argparse.Namespace) -> None:
    from viscoin_tpu_torch.cli.utils import card_or_cpu
    from viscoin_tpu_torch.utils.checkpoints import load_viscoin_bundle
    from viscoin_tpu_torch.utils.plotting import plot_grid

    device = card_or_cpu("amplify-pca", args.device)
    models = load_viscoin_bundle(args.viscoin_pickle_path, device=device)
    _, images = w_plus_pca(models, args.dataset, args.pca, args.image)
    for i in range(int(np.ceil(args.pca / 5))):
        hi = min((i + 1) * 5, args.pca)
        path = plot_grid(images[i * 5: hi], "W+ amplification along PCA component",
                         [f"x{f}" for f in MULTIPLIERS],
                         [f"Component {j + 1}" for j in range(i * 5, hi)],
                         outdir=args.outdir, name=f"amplify_pca_{i}")
        print(f"wrote {path}")
