"""Figures: the counterparts of ``viscoin_tpu/utils/plotting.py``, each
written as a PNG instead of shown (the card's machines have no display).

Figures are made with matplotlib's object interface (``Figure``, no
pyplot), so no backend is selected and nothing global changes; matplotlib
is imported only when a figure is drawn.
"""

from __future__ import annotations

import os

import numpy as np


def new_figure(nrows: int = 1, ncols: int = 1, squeeze: bool = True, **kw):
    """(figure, axes) as ``plt.subplots`` gives them, without pyplot;
    ``kw`` go to the ``Figure``."""
    from matplotlib.figure import Figure

    fig = Figure(**kw)
    return fig, fig.subplots(nrows, ncols, squeeze=squeeze)


def save_figure(fig, outdir: str, name: str) -> str:
    """Write ``fig`` to ``{outdir}/{name}.png`` (the directory made if
    missing) and return the path."""
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"{name}.png")
    fig.savefig(path)
    return path


def plot_grid(images: np.ndarray, title: str, column_titles: list[str], row_titles: list[str],
              outdir: str = ".", name: str = "grid") -> str:
    """A grid of images with row and column titles; ``images`` (rows, cols,
    H, W, 3). Returns the PNG's path."""
    rows, cols = len(row_titles), len(column_titles)
    fig, axes = new_figure(rows, cols, figsize=(15, 5 * rows))
    fig.suptitle(title)
    axes = np.atleast_2d(axes)
    for i in range(rows):
        for j in range(cols):
            ax = axes[i, j]
            ax.imshow(images[i, j])
            if i == 0:
                ax.set_title(column_titles[j])
            if j == 0:
                ax.set_ylabel(row_titles[i], rotation=0, labelpad=40)
            ax.xaxis.set_visible(False)
            for spine in ax.spines.values():
                spine.set_visible(False)
            ax.tick_params(left=False, labelleft=False)
    return save_figure(fig, outdir, name)


def plot_amplified_images_batch(originals, images, multipliers, labels=None, outdir: str = ".",
                                name: str = "amplify") -> str:
    """Rows of [original | amplified x m ...]. Returns the PNG's path."""
    from viscoin_tpu_torch.utils.images import from_torch

    np_rows = [[from_torch(img) for img in row] for row in images]
    np_orig = [from_torch(o) for o in originals]
    num_rows, num_cols = len(images), len(multipliers) + 1
    fig, axs = new_figure(num_rows, num_cols, figsize=(15, 5 * num_rows))
    fig.suptitle("Amplification of best concepts for an image")
    axs = np.atleast_2d(np.asarray(axs))
    for i, (orig, row) in enumerate(zip(np_orig, np_rows)):
        axs[i, 0].imshow(orig)
        axs[i, 0].axis("off")
        if labels is not None:
            axs[i, 0].set_title(f"Predicted Label : {labels[i]}\nOriginal")
        elif i == 0:
            axs[i, 0].set_title("Original")
        for j, (img, mult) in enumerate(zip(row, multipliers)):
            axs[i, j + 1].imshow(img)
            axs[i, j + 1].axis("off")
            if i == 0:
                axs[i, j + 1].set_title(f"Multiplier: {mult:.2f}")
    return save_figure(fig, outdir, name)
