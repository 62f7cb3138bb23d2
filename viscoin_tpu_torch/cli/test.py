"""The ``test`` command: ``python -m viscoin_tpu_torch test classifier ...``.

Counterpart of ``viscoin_tpu/cli/test.py``: the classifier's accuracy and
mean loss over the dataset's test split, with the weights of
``--checkpoints`` (npz layout, what ``train classifier`` and ``port-weights
classifier`` write) or random ones from seed 0; on the card unless given
``--device cpu``.
"""

from __future__ import annotations

import argparse

from viscoin_tpu_torch.cli.utils import add_common_options
from viscoin_tpu_torch.data.utils import get_dataloaders


def add_parser(subparsers) -> argparse.ArgumentParser:
    p = subparsers.add_parser("test", help="Test a model on a dataset.")
    p.add_argument("model_name", help="classifier")
    add_common_options(p)
    p.set_defaults(func=test, parser=p)
    return p


def test(args: argparse.Namespace) -> tuple[float, float]:
    from viscoin_tpu_torch.cli.train import build_classifier
    from viscoin_tpu_torch.cli.utils import card_or_cpu
    from viscoin_tpu_torch.eval.classifiers import test_classifier
    from viscoin_tpu_torch.utils import checkpoints as ckpt
    from viscoin_tpu_torch.utils.weights import load_jax_tree

    if args.model_name != "classifier":
        raise ValueError(f"Unknown model name: {args.model_name}")
    device = card_or_cpu("test", args.device)
    _, dataloader = get_dataloaders(args.dataset, batch_size=args.batch_size or 32)
    model = build_classifier(dataloader.dataset.N_CLASSES, device)
    if args.checkpoints is not None:
        load_jax_tree(model, ckpt.restore_pytree(args.checkpoints))
    accuracy, loss = test_classifier(model, dataloader)
    print(f"Accuracy: {100 * accuracy:.2f}%")
    print(f"Loss: {loss}")
    return accuracy, loss
