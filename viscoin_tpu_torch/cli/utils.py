"""Options shared by the commands, with the JAX command line's names and
defaults (``viscoin_tpu/cli/utils.py``), for ``argparse``. ``--device``
defaults to "cuda"; the CPU runs only when asked for."""

from __future__ import annotations

import argparse
import os

from viscoin_tpu_torch.data.utils import DATASET_NAMES


def dataset_arg(value: str) -> str:
    """A registry dataset name, a folder-per-class directory or a training zip."""
    if value in DATASET_NAMES or os.path.isdir(value) or (
            value.lower().endswith(".zip") and os.path.isfile(value)):
        return value
    raise argparse.ArgumentTypeError(
        f"{value!r} is neither a known dataset ({', '.join(sorted(DATASET_NAMES))}), nor a "
        "directory path (image-folder layout: {root}/{train|test}/{class}/{image}), nor a "
        "training .zip")


def existing_path(value: str) -> str:
    if not os.path.exists(value):
        raise argparse.ArgumentTypeError(f"path {value!r} does not exist")
    return value


def add_common_options(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--batch-size", type=int, default=None,
                        help="The batch size to use for training/testing")
    parser.add_argument("--device", default="cuda",
                        help="The torch device to run on: cuda (default) or cpu")
    parser.add_argument("--dataset", type=dataset_arg, default="cub",
                        help="The dataset to use: cub | synthetic | a directory path "
                             "(image-folder layout)")
    parser.add_argument("--epochs", type=int, default=None,
                        help="The amount of epochs to train the model for (iterations for "
                             "viscoin)")
    parser.add_argument("--learning-rate", type=float, default=None,
                        help="The optimizer learning rate")
    parser.add_argument("--output-weights", default="output-weights",
                        help="The path/filename where to save the weights")
    parser.add_argument("--checkpoints", default=None,
                        help="The path to load the checkpoints")
