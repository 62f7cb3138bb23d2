"""The ``concept-heatmaps`` command: GradCAM heatmaps of Psi's five
convolutions over random test images.

Counterpart of ``viscoin_tpu/cli/concept_heatmaps.py``, with its options,
plus ``--device`` (the card by default) and ``--outdir``, where the figure
goes (``concept_heatmaps.png``; the JAX command shows it):

    python -m viscoin_tpu_torch concept-heatmaps --dataset synthetic

The 5 images are drawn from an unseeded generator, as in the JAX command;
the heatmaps are ``utils/gradcam.py::concept_extractor_gradcams`` at the
dataset labels.
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

N_SAMPLES = 5
COLUMNS = ["original", "conv1 from hidden_state[-3]", "conv2 from hidden_state[-2]",
           "conv3 from hidden_state[-1]", "conv4 after concat", "conv5 after conv4"]


def add_parser(subparsers) -> None:
    p = subparsers.add_parser("concept-heatmaps", help="Generate GradCAM heatmaps for random "
                                                       "images, for the 5 convolutional layers "
                                                       "of the concept extractor.")
    add_viscoin_pickle_option(p)
    add_device_option(p)
    add_dataset_option(p)
    add_outdir_option(p)
    p.set_defaults(func=concept_heatmaps)


def heatmap_batch(models, test_ds, indices):
    """(preprocessed images NCHW, labels, {conv name: (B, h, w) numpy},
    explainer logits numpy) for ``indices`` of ``test_ds``."""
    import torch

    from viscoin_tpu_torch.data.transforms import device_preprocess
    from viscoin_tpu_torch.utils.gradcam import concept_extractor_gradcams

    p = next(models.parameters())
    raw = np.stack([test_ds[int(i)][0] for i in indices])
    labels = np.asarray([test_ds[int(i)][1] for i in indices], np.int64)
    images = device_preprocess(torch.from_numpy(raw).to(p.device)).to(p.dtype)
    heatmaps, logits = concept_extractor_gradcams(models, images,
                                                  torch.from_numpy(labels).to(p.device))
    return images, labels, heatmaps, logits


def draw_heatmaps(images, labels, heatmaps, logits, outdir: str) -> str:
    from viscoin_tpu_torch.utils.gradcam import CONVS
    from viscoin_tpu_torch.utils.images import from_torch, heatmap_to_img, overlay
    from viscoin_tpu_torch.utils.plotting import new_figure, save_figure

    n = len(labels)
    explainer_labels = logits.argmax(axis=1)
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    fig, axs = new_figure(n, 6, figsize=(20, 10), squeeze=False)
    fig.suptitle("GradCAM heatmaps of the concept extractor convolutional layers")
    for row in range(n):
        is_correct = labels[row] == explainer_labels[row]
        axs[row, 0].set_ylabel(f"{is_correct} with {100 * probs[row].max():.0f}%", fontsize=8)
        base = from_torch(images[row])
        for col in range(6):
            if col == 0:
                axs[row, col].imshow(base)
            else:
                axs[row, col].axis("off")
                axs[row, col].imshow(overlay(
                    (base * 255).astype(np.uint8),
                    heatmap_to_img(heatmaps[CONVS[col - 1]][row], size=base.shape[0])))
            if row == 0:
                axs[row, col].set_title(COLUMNS[col], fontsize=8)
    return save_figure(fig, outdir, "concept_heatmaps")


def concept_heatmaps(args: argparse.Namespace) -> None:
    from viscoin_tpu_torch.cli.utils import card_or_cpu
    from viscoin_tpu_torch.data.utils import get_datasets
    from viscoin_tpu_torch.utils.checkpoints import load_viscoin_bundle

    device = card_or_cpu("concept-heatmaps", args.device)
    models = load_viscoin_bundle(args.viscoin_pickle_path, device=device)
    _, test_ds = get_datasets(args.dataset)
    indices = np.random.default_rng().choice(len(test_ds), N_SAMPLES, replace=False)
    path = draw_heatmaps(*heatmap_batch(models, test_ds, indices), outdir=args.outdir)
    print(f"heatmaps of images {[int(i) for i in indices]}: wrote {path}")
