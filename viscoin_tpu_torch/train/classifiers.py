"""Classifier training: the first stage of the paper's pipeline.

Counterpart of ``viscoin_tpu/train/classifiers.py``: Adam (or SGD with
momentum) on optax's piecewise-constant schedule, the rate x0.1 from step
30 * E and again from step 60 * E (E the steps of an epoch: a boundary is a
step count, not an epoch end); a per-image horizontal flip drawn per step;
BatchNorm on the batch's statistics with the running ones updated (flax's
rule, ``models/resnet.py``); the loss in fp32, the compute in
``compute_dtype`` (bf16 copies of the fp32 masters through
``torch.func.functional_call``); a test pass per epoch, the variables of the
best test accuracy kept and returned in the JAX package's layout. The jsonl
records carry the JAX trainer's keys, with the train epoch's own accuracy.

What differs from JAX, by design: the flips of step s come from a
generator seeded ``fold_seed(seed, s)`` and are passed to the step, so a
test can hand it JAX's flips.

Data parallelism (``mesh``): one process per card on its shard of each
global batch; BatchNorm's statistics are the global batch's (the JAX
step's under GSPMD), the gradients are averaged over the ranks, and the
logged metrics and the test pass are global. Each rank draws its own flips.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from viscoin_tpu_torch.data.transforms import device_preprocess
from viscoin_tpu_torch.eval.classifiers import test_classifier
from viscoin_tpu_torch.eval.viscoin import to_device
from viscoin_tpu_torch.parallel.mesh import Mesh, all_reduce_grads, all_sum, is_main
from viscoin_tpu_torch.train.viscoin import _dtype, fold_seed, rank_seed
from viscoin_tpu_torch.utils.dataclasses import IgnoreNone
from viscoin_tpu_torch.utils.logging import get_logger
from viscoin_tpu_torch.utils.weights import module_to_jax_tree

BOUNDARY_EPOCHS = (30, 60)  # StepLR(30, 0.1) of the reference, as step counts
DECAY = 0.1


@dataclass
class ClassifierTrainingParams(IgnoreNone):
    """The JAX package's defaults; ``None`` arguments keep them."""

    epochs: int = 90
    learning_rate: float = 0.001
    batch_size: int = 32
    optimizer: str = "adam"  # or "sgd"
    momentum: float = 0.9  # SGD only
    compute_dtype: str = "float32"


@dataclass
class ClassifierState:
    """The classifier (fp32 masters and running statistics, updated in
    place), its optimizer, the rate schedule, and the steps taken."""

    classifier: torch.nn.Module
    opt: torch.optim.Optimizer
    schedule: object
    step: int = 0


def make_lr_schedule(base_lr: float, steps_per_epoch: int):
    """optax's ``piecewise_constant_schedule(base_lr, {30 E: 0.1, 60 E:
    0.1})``: the rate of the update with ``count`` updates before it, x0.1
    for each boundary count has reached, in float32 as optax computes it."""
    boundaries = [b * steps_per_epoch for b in BOUNDARY_EPOCHS]

    def schedule(count: int) -> float:
        v = np.float32(base_lr)
        for b in boundaries:
            if count >= b:
                v = np.float32(v * np.float32(DECAY))
        return float(v)

    return schedule


def create_classifier_state(classifier, params: ClassifierTrainingParams,
                            steps_per_epoch: int) -> ClassifierState:
    """The optimizer over the classifier's parameters: optax's ``adam``
    (b1 0.9, b2 0.999, eps 1e-8) or ``sgd`` with momentum (the trace
    g + momentum * trace, no dampening)."""
    weights = list(classifier.parameters())
    for p in weights:
        p.requires_grad_(True)
    if params.optimizer == "adam":
        opt = torch.optim.Adam(weights, lr=params.learning_rate, betas=(0.9, 0.999), eps=1e-8)
    elif params.optimizer == "sgd":
        opt = torch.optim.SGD(weights, lr=params.learning_rate, momentum=params.momentum)
    else:
        raise ValueError(f"optimizer={params.optimizer!r}: expected adam|sgd")
    return ClassifierState(classifier, opt, make_lr_schedule(params.learning_rate,
                                                             steps_per_epoch))


def draw_flips(seed: int, step: int, batch: int, device, mesh: Mesh | None = None):
    """Step ``step``'s flips: (B,) bool from a generator seeded (seed, step)
    (and the rank, under data parallelism)."""
    gen = torch.Generator(device=device).manual_seed(rank_seed(fold_seed(seed, step), mesh))
    return torch.rand(batch, device=device, generator=gen) < 0.5


def classifier_loss(classifier, images_u8, labels, flips, compute_dtype: str = "float32",
                    mesh: Mesh | None = None):
    """The loss of one training step, (loss, correct): the flip preprocess,
    the forward in ``compute_dtype`` with BatchNorm in train mode (which
    moves the running statistics; over a ``mesh``, the global batch's), the
    fp32 mean cross-entropy (this rank's). The loss differentiates to the
    fp32 masters."""
    dt = _dtype(compute_dtype)
    x = device_preprocess(images_u8, flips).to(dt)
    if dt == torch.float32:
        logits, _ = classifier(x, train=True, mesh=mesh)
    else:
        cast = {k: p.to(dt) for k, p in classifier.named_parameters()}
        logits, _ = functional_call(classifier, cast, (x,), {"train": True, "mesh": mesh})
    logits = logits.float()
    return F.cross_entropy(logits, labels), (logits.argmax(dim=1) == labels).sum()


def make_classifier_train_step(compute_dtype: str = "float32", mesh: Mesh | None = None):
    """``step(state, images_u8, labels, flips) -> (loss, correct)`` (device
    tensors): :func:`classifier_loss`, one backward and one update at
    ``schedule(state.step)``. With a ``mesh`` the inputs are this rank's
    shard, the update takes the gradients' mean over the ranks, and the
    loss and the count of correct predictions are the global batch's."""
    _dtype(compute_dtype)

    def step(state: ClassifierState, images_u8, labels, flips):
        weights = dict(state.classifier.named_parameters())
        loss, correct = classifier_loss(state.classifier, images_u8, labels, flips,
                                        compute_dtype, mesh)
        grads = torch.autograd.grad(loss, list(weights.values()))
        if mesh is not None:
            grads = all_reduce_grads(list(grads), mesh)
            loss, correct = all_sum(torch.stack([loss.detach() / mesh.world,
                                                 correct.to(loss.dtype)]), mesh)
        apply_gradients(state, grads)
        return loss.detach(), correct

    return step


@torch.no_grad()
def apply_gradients(state: ClassifierState, grads) -> None:
    """One update of the classifier's parameters (in ``named_parameters``
    order) at the rate ``schedule(state.step)``."""
    for p, g in zip(state.classifier.parameters(), grads, strict=True):
        p.grad = g
    for group in state.opt.param_groups:
        group["lr"] = state.schedule(state.step)
    state.opt.step()
    state.opt.zero_grad(set_to_none=True)
    state.step += 1


def classifier_variables(classifier) -> dict:
    """The classifier's {params, batch_stats}, copied to the host in the JAX
    package's layout (what ``train classifier`` saves)."""
    tree = module_to_jax_tree(classifier)
    return {"params": tree["params"], "batch_stats": tree["batch_stats"]}


def train_classifier(classifier, train_loader, test_loader, params: ClassifierTrainingParams,
                     seed: int = 0, mesh: Mesh | None = None) -> tuple[dict, float]:
    """Train ``classifier`` in place on the device it lives on; returns (the
    variables of the best test accuracy, that accuracy). Ragged train
    batches are skipped, as in the JAX package. With a ``mesh`` both
    loaders are this rank's shards (``DataLoader(shard=(rank, world))``,
    ``params.batch_size`` the global batch); every rank returns the same
    variables and only rank 0 logs."""
    logger = get_logger()
    loader_bs = getattr(train_loader, "batch_size", params.batch_size)
    if loader_bs != params.batch_size:
        raise ValueError(f"train_loader.batch_size={loader_bs} != "
                         f"params.batch_size={params.batch_size}")
    world = 1 if mesh is None else mesh.world
    if getattr(train_loader, "shard", (0, 1))[1] != world:
        raise ValueError(f"train_loader.shard={getattr(train_loader, 'shard', (0, 1))}: a run "
                         f"over {world} process(es) needs DataLoader(shard=(rank, {world}))")
    rows = params.batch_size // world
    device = next(classifier.parameters()).device
    state = create_classifier_state(classifier, params, max(1, len(train_loader)))
    step = make_classifier_train_step(params.compute_dtype, mesh)
    best_accuracy = 0.0
    best = classifier_variables(classifier)
    for _ in range(params.epochs):
        sums = torch.zeros(2, dtype=torch.float64, device=device)  # loss, correct
        total_samples = n_batches = 0
        for images, labels in train_loader:
            if images.shape[0] != rows:
                continue
            flips = draw_flips(seed, state.step, rows, device, mesh)
            loss, correct = step(state, to_device(images, device),
                                 to_device(labels.astype(np.int64), device), flips)
            sums += torch.stack([loss.double(), correct.double()])
            total_samples += params.batch_size
            n_batches += 1
        total_loss, total_correct = sums.cpu().tolist()
        accuracy, mean_loss = test_classifier(classifier, test_loader, mesh)
        if accuracy > best_accuracy:
            best_accuracy = accuracy
            best = classifier_variables(classifier)
        if is_main(mesh):
            logger.info(json.dumps({
                "train_loss": total_loss / max(n_batches, 1),
                "train_accuracy": total_correct / max(total_samples, 1),
                "test_loss": mean_loss,
                "test_accuracy": accuracy,
            }))
    if is_main(mesh):
        print(f"Best test accuracy: {best_accuracy:.4f}")
    return best, best_accuracy
