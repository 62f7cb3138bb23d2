"""``python -m viscoin_tpu_torch <command> ...``: the port's command line.

    python -m viscoin_tpu_torch train viscoin --dataset synthetic --epochs 100
    python -m viscoin_tpu_torch train gan --dataset synthetic --epochs 100
    python -m viscoin_tpu_torch train viscoin --device cpu ...   # the plain versions

Only ``train viscoin`` and ``train gan`` are ported; see ``cli/train.py``.
"""

from __future__ import annotations

import argparse
import sys

from viscoin_tpu_torch.cli import train as train_cmd


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m viscoin_tpu_torch",
                                     description="VisCoIN on PyTorch/CUDA.")
    sub = parser.add_subparsers(dest="command", required=True)
    train_cmd.add_parser(sub)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    args.func(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
