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
    add_device_option(parser)
    parser.add_argument("--dataset", type=dataset_arg, default="cub",
                        help="The dataset to use: cub | synthetic | a directory path "
                             "(image-folder layout) | a training .zip (train gan only)")
    parser.add_argument("--epochs", type=int, default=None,
                        help="The amount of epochs to train the model for (iterations for "
                             "viscoin)")
    parser.add_argument("--learning-rate", type=float, default=None,
                        help="The optimizer learning rate")
    parser.add_argument("--output-weights", default="output-weights",
                        help="The path/filename where to save the weights")
    parser.add_argument("--checkpoints", default=None,
                        help="The path to load the checkpoints")


def card_or_cpu(command: str, device) -> "torch.device":
    """``device`` as a torch device; "cuda" without a card raises (the CPU
    runs the plain versions only when asked for)."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{command} --device cuda: no CUDA device is available; pass "
                           "--device cpu to run with the plain versions on the CPU")
    return device


def load_generator(gan_path: str, device):
    """The frozen :class:`Generator` of a ``train gan`` export or a
    ``port-weights stylegan`` output (the npz layout: {params, noise,
    moving_stats}), rebuilt from the weights it holds (no shape flags), on
    ``device``, in eval mode, with no parameter requiring a gradient. Shared
    by ``generate``, ``style-mixing``, ``project`` and ``fid``."""
    from viscoin_tpu_torch.cli.port_weights import generator_from_tree
    from viscoin_tpu_torch.utils import checkpoints as ckpt

    return generator_from_tree(ckpt.restore_pytree(gan_path), device).eval().requires_grad_(False)


def require_lpips(parser: argparse.ArgumentParser, why: str, device,
                  path: str = "checkpoints/lpips-vgg"):
    """The LPIPS-VGG of ``path`` (what ``port-weights lpips`` writes) on
    ``device``, frozen; without it, a usage error pointing there: the
    perceptual metrics (the projection's loss, PPL) mean nothing through a
    random VGG."""
    if not os.path.exists(path):
        parser.error(f"{why} needs LPIPS weights at {path} (port them with `python -m "
                     "viscoin_tpu_torch port-weights lpips`)")
    from viscoin_tpu_torch.models.lpips import LPIPS
    from viscoin_tpu_torch.utils import checkpoints as ckpt
    from viscoin_tpu_torch.utils.weights import load_jax_tree

    lpips = load_jax_tree(LPIPS(device=device), {"params": ckpt.restore_pytree(path)})
    return lpips.eval().requires_grad_(False)


def add_gan_option(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--gan", dest="gan_path", type=existing_path, required=True,
                        help="Generator variables: a `train gan` export or a `port-weights "
                             "stylegan` output (architecture inferred)")


def add_viscoin_pickle_option(parser: argparse.ArgumentParser) -> None:
    from viscoin_tpu_torch.data.utils import DEFAULT_VISCOIN

    parser.add_argument("--viscoin-pickle-path", default=DEFAULT_VISCOIN,
                        help=f"The path to the viscoin checkpoint bundle (default "
                             f"{DEFAULT_VISCOIN})")


def add_outdir_option(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--outdir", default=".",
                        help="Where the figures are written as PNG files (default .)")


def add_dataset_option(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--dataset", type=dataset_arg, default="cub",
                        help="cub | funnybirds | synthetic | an image-folder path")


def add_device_option(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="The torch device to run on: cuda (default) or cpu")
