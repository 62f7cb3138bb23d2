"""``python -m viscoin_tpu_torch <command> ...``: the port's command line.

    python -m viscoin_tpu_torch port-weights classifier model.pt checkpoints/cub/classifier-cub
    python -m viscoin_tpu_torch train classifier --dataset synthetic --epochs 2
    python -m viscoin_tpu_torch test classifier --checkpoints output-weights
    python -m viscoin_tpu_torch train gan --dataset synthetic --epochs 100 --fid-every 50
    python -m viscoin_tpu_torch train viscoin --dataset synthetic --epochs 100
    python -m viscoin_tpu_torch train viscoin --device cpu ...   # the plain versions

The commands: ``port-weights`` (``cli/port_weights.py``), ``train classifier
| viscoin | gan`` (``cli/train.py``) and ``test classifier`` (``cli/test.py``).
Each runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys

from viscoin_tpu_torch.cli import port_weights as port_weights_cmd
from viscoin_tpu_torch.cli import test as test_cmd
from viscoin_tpu_torch.cli import train as train_cmd


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m viscoin_tpu_torch",
                                     description="VisCoIN on PyTorch/CUDA.")
    sub = parser.add_subparsers(dest="command", required=True)
    train_cmd.add_parser(sub)
    test_cmd.add_parser(sub)
    port_weights_cmd.add_parser(sub)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    args.func(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
