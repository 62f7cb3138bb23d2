"""The ``to-pickle`` command: re-save a raw joint checkpoint as a
self-describing bundle with the default hyperparameters.

Counterpart of ``viscoin_tpu/cli/to_pickle.py``, with its options, plus
``--device`` (the card by default), where the modules are built:

    python -m viscoin_tpu_torch to-pickle --checkpoints raw --output checkpoints/cub/viscoin-cub
"""

from __future__ import annotations

import argparse

from viscoin_tpu_torch.cli.utils import add_device_option


def add_parser(subparsers) -> None:
    p = subparsers.add_parser("to-pickle", help="Convert a raw joint checkpoint to a "
                                                "self-describing viscoin bundle using default "
                                                "hyperparameters.")
    p.add_argument("--checkpoints", default=None, help="The path to load the checkpoints")
    p.add_argument("--output", default=None, help="The path to generate the bundle to")
    add_device_option(p)
    p.set_defaults(func=to_pickle)


def to_pickle(args: argparse.Namespace) -> None:
    from viscoin_tpu_torch.cli.utils import card_or_cpu
    from viscoin_tpu_torch.models.bundle import default_models
    from viscoin_tpu_torch.utils.checkpoints import load_viscoin, save_viscoin

    device = card_or_cpu("to-pickle", args.device)
    models = load_viscoin(default_models(device=device), args.checkpoints)
    save_viscoin(models, args.output)
    print(f"wrote the bundle {args.output} (default hyperparameters, from {args.checkpoints})")
