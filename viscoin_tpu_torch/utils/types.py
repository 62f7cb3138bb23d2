"""The result records of VisCoIN's training and eval, and their plots.

Counterpart of ``viscoin_tpu/utils/types.py``. The field names define the
jsonl schema of the ``train_*`` and ``test_*`` keys, so logs of either
package read the same. Each ``plot_*`` writes a PNG to ``outdir`` (instead
of showing it) and returns its path.
"""

from __future__ import annotations

from dataclasses import dataclass


def _plot_keys(results: list, keys: tuple[str, ...], title: str, ylabel: str, outdir: str,
               name: str) -> str:
    from viscoin_tpu_torch.utils.plotting import new_figure, save_figure

    fig, ax = new_figure()
    for key in keys:
        ax.plot([getattr(r, key) for r in results], label=key)
    ax.set_title(title)
    ax.set_ylabel(ylabel)
    ax.set_xlabel("per 20,000 batches")
    ax.legend()
    return save_figure(fig, outdir, name)


@dataclass
class TestingResults:
    """Averages over a test set (losses) and percentages (predictions)."""

    __test__ = False  # a record, not a pytest class

    acc_loss: float
    cr_loss: float
    of_loss: float
    lp_loss: float
    rec_loss_l1: float
    rec_loss_l2: float
    preds_overlap: float
    correct_preds: float
    correct_expl_preds: float
    fid_score: float | None = None

    @staticmethod
    def plot_losses(results: list["TestingResults"], outdir: str = ".") -> str:
        return _plot_keys(results, ("acc_loss", "cr_loss", "of_loss", "lp_loss", "rec_loss_l1",
                                    "rec_loss_l2"), "Testing Losses", "Loss", outdir,
                          "testing_losses")

    @staticmethod
    def plot_preds_overlap(results: list["TestingResults"], outdir: str = ".") -> str:
        return _plot_keys(results, ("preds_overlap", "correct_preds", "correct_expl_preds"),
                          "Prediction Overlaps", "Overlap", outdir, "preds_overlap")


@dataclass
class TrainingResults:
    """VisCoIN's training losses."""

    acc_loss: float
    cr_loss: float
    of_loss: float
    ortho_loss: float
    rec_loss: float
    gan_loss: float
    inter_loss: float

    @staticmethod
    def plot_losses(results: list["TrainingResults"], outdir: str = ".") -> str:
        return _plot_keys(results, ("acc_loss", "cr_loss", "of_loss", "ortho_loss", "rec_loss",
                                    "gan_loss", "inter_loss"), "Training Losses", "Loss", outdir,
                          "training_losses")
