"""Concept distribution analytics over a test set.

Counterpart of ``viscoin_tpu/eval/concepts.py``. Each batch runs f, Psi and
Theta once on the bundle's device and returns its per-batch sums there (the
accuracies' counts, the sorted and summed pooled activations, the
concept x concept and class x concept products, the class counts), with the
rows that ``data/loader.py::pad_batch`` adds to a short last batch masked
out; the host accumulates them in float64. The plots are the JAX methods',
each written as a PNG to a given directory instead of shown.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from viscoin_tpu_torch.data.loader import pad_batch
from viscoin_tpu_torch.data.transforms import device_preprocess
from viscoin_tpu_torch.eval.viscoin import _placement, to_device
from viscoin_tpu_torch.models.bundle import VisCoINModels
from viscoin_tpu_torch.models.concept_extractor import max_pool_concepts
from viscoin_tpu_torch.utils.maths import normalize

SUM_KEYS = ("act_sorted", "act_sum", "corr", "class_corr", "class_counts")


@dataclass
class ConceptTestResults:
    """The JAX package's fields and plots; each ``plot_*`` writes
    ``{outdir}/{name}.png`` and returns its path."""

    __test__ = False  # a record, not a pytest class

    classifier_accuracy: float
    explainer_accuracy: float
    concept_activation_per_image: np.ndarray
    concept_activation_per_concept: np.ndarray
    raw_concept_mean_activation: np.ndarray
    concept_correlations: np.ndarray
    class_concept_correlations: np.ndarray
    concept_class_correlations: np.ndarray
    concept_entropy: np.ndarray
    class_counts: np.ndarray

    def print_accuracies(self):
        print(f"Classifier accuracy: {self.classifier_accuracy * 100:2f}%")
        print(f"Explainer accuracy: {self.explainer_accuracy * 100:2f}%")

    def plot_concept_activation_per_concept(self, outdir: str = ".") -> str:
        from viscoin_tpu_torch.utils.plotting import new_figure, save_figure

        fig, ax = new_figure()
        ax.hist(self.concept_activation_per_concept, bins=30, edgecolor="black")
        ax.set_title("Concept activation per concept over the test dataset")
        ax.set_xlabel("Activation (% of total activation)")
        ax.set_ylabel("Amount of concepts")
        ax.grid()
        return save_figure(fig, outdir, "concept_activation_per_concept")

    def plot_concept_activation_per_image(self, outdir: str = ".") -> str:
        from viscoin_tpu_torch.utils.plotting import new_figure, save_figure

        fig, ax = new_figure()
        ax.hist(self.concept_activation_per_image, bins=30, edgecolor="black")
        ax.set_title("Concept activation per image over the test dataset")
        ax.set_xlabel("Activation (% of total activation)")
        ax.set_ylabel("Amount of concepts")
        ax.grid()
        return save_figure(fig, outdir, "concept_activation_per_image")

    def plot_class_concept_correlations(self, outdir: str = ".") -> str:
        from viscoin_tpu_torch.utils.plotting import new_figure, save_figure

        concept_order = self.class_concept_correlations.mean(axis=0).argsort()
        class_order = self.class_concept_correlations.mean(axis=1).argsort()
        fig, ax = new_figure()
        ax.imshow(self.class_concept_correlations[:, concept_order][class_order, :])
        ax.set_title("Sorted importance of concepts for each class")
        ax.set_xlabel("Concept")
        ax.set_ylabel("Class")
        return save_figure(fig, outdir, "class_concept_correlations")

    def plot_concept_class_correlations(self, outdir: str = ".") -> str:
        from viscoin_tpu_torch.utils.plotting import new_figure, save_figure

        class_order = self.concept_class_correlations.mean(axis=0).argsort()
        concept_order = self.concept_class_correlations.mean(axis=1).argsort()
        fig, ax = new_figure()
        ax.imshow(self.concept_class_correlations[concept_order, :][:, class_order].T)
        ax.set_title("Sorted importance of classes for each concept")
        ax.set_xlabel("Concept")
        ax.set_ylabel("Class")
        return save_figure(fig, outdir, "concept_class_correlations")

    def plot_concept_entropies(self, outdir: str = ".") -> str:
        from viscoin_tpu_torch.utils.plotting import new_figure, save_figure

        fig, ax = new_figure()
        ax.plot(self.concept_entropy[self.raw_concept_mean_activation.argsort()][::-1],
                label="Concept entropy by average activation")
        ax.plot(np.sort(self.concept_entropy), label="Sorted concept entropies")
        ax.grid()
        ax.set_title("Concept entropy among classes (higher means less class-separating)")
        ax.set_xlabel("Concept")
        ax.set_ylabel("Entropy")
        ax.legend()
        return save_figure(fig, outdir, "concept_entropies")

    def plot_all(self, outdir: str = ".") -> list[str]:
        """Every plot, in the JAX command's order."""
        return [self.plot_concept_activation_per_concept(outdir),
                self.plot_concept_activation_per_image(outdir),
                self.plot_class_concept_correlations(outdir),
                self.plot_concept_class_correlations(outdir),
                self.plot_concept_entropies(outdir)]


def make_concept_batch_fn(models: VisCoINModels, n_classes: int):
    """``(images_u8 (B, H, W, 3), labels (B,), valid (B,) float) -> dict`` of
    the batch's masked sums (tensors on the bundle's device)."""

    @torch.no_grad()
    def batch_stats(images_u8, labels, valid):
        _, dtype = _placement(models)
        x = device_preprocess(images_u8).to(dtype)
        classes, hidden = models.classifier(x)
        phi, _ = models.concept_extractor(tuple(hidden[-3:]))
        expl = models.explainer(phi)
        acts = max_pool_concepts(phi).float() * valid[:, None]  # (B, K)
        preds, preds_expl = classes.argmax(dim=1), expl.argmax(dim=1)
        onehot = F.one_hot(labels.long(), n_classes).float() * valid[:, None]  # (B, C)
        return {
            "cls_correct": ((preds == labels) * valid).sum(),
            "expl_correct": ((preds_expl == labels) * valid).sum(),
            "act_sorted": (torch.sort(acts, dim=1).values * valid[:, None]).sum(dim=0),
            "act_sum": acts.sum(dim=0),
            "corr": acts.T @ acts,  # (K, K)
            "class_corr": onehot.T @ acts,  # (C, K)
            "class_counts": onehot.sum(dim=0),
        }

    return batch_stats


def concept_sums(models: VisCoINModels, dataloader, n_classes: int) -> dict:
    """The device's part of :func:`test_concepts`: each batch's accuracies
    (``cls_accs``, ``expl_accs``, one per batch) and :data:`SUM_KEYS` summed
    over the batches in float64 on the host."""
    device, _ = _placement(models)
    batch_stats = make_concept_batch_fn(models, n_classes)
    acc: dict = {"cls_accs": [], "expl_accs": []}
    for images, labels in dataloader:
        images, labels, valid = pad_batch(dataloader.batch_size, images, labels)
        n = int(valid.sum())
        out = batch_stats(to_device(images, device), to_device(labels, device),
                          to_device(valid, device))
        out = {k: v.double().cpu().numpy() for k, v in out.items()}  # one sync per batch
        acc["cls_accs"].append(float(out["cls_correct"]) / n)
        acc["expl_accs"].append(float(out["expl_correct"]) / n)
        for k in SUM_KEYS:
            acc[k] = acc.get(k, 0) + out[k]
    return acc


def concept_results(acc: dict) -> ConceptTestResults:
    """The statistics of :func:`concept_sums`' sums, on the host."""
    class_counts = acc["class_counts"]
    class_concept = acc["class_corr"]  # (C, K)
    balanced = class_concept / np.maximum(class_counts[:, None], 1) * class_counts.max()

    # Each concept's distribution over the classes, and its entropy.
    z = balanced - balanced.max(axis=0, keepdims=True)
    p = np.exp(z) / np.exp(z).sum(axis=0, keepdims=True)
    entropies = -np.sum(p * np.log(p + 1e-6), axis=0)

    return ConceptTestResults(
        classifier_accuracy=float(np.mean(acc["cls_accs"])),
        explainer_accuracy=float(np.mean(acc["expl_accs"])),
        concept_activation_per_image=normalize(acc["act_sorted"]),
        concept_activation_per_concept=np.sort(normalize(acc["act_sum"])),
        raw_concept_mean_activation=normalize(acc["act_sum"]),
        concept_correlations=normalize(acc["corr"]),
        class_concept_correlations=normalize(class_concept, axis=1),
        concept_class_correlations=normalize(balanced, axis=0).T,
        class_counts=class_counts,
        concept_entropy=normalize(entropies),
    )


def test_concepts(models: VisCoINModels, dataloader, n_classes: int) -> ConceptTestResults:
    """Dataset-wide concept statistics on the bundle's device."""
    return concept_results(concept_sums(models, dataloader, n_classes))
