"""``python -m viscoin_tpu_torch <command> ...``: the port's command line.

    python -m viscoin_tpu_torch port-weights classifier model.pt checkpoints/cub/classifier-cub
    python -m viscoin_tpu_torch train classifier --dataset synthetic --epochs 2
    python -m viscoin_tpu_torch test classifier --checkpoints output-weights
    python -m viscoin_tpu_torch train gan --dataset synthetic --epochs 100 --fid-every 50
    python -m viscoin_tpu_torch train viscoin --dataset synthetic --epochs 100
    python -m viscoin_tpu_torch train viscoin --device cpu ...   # the plain versions
    python -m viscoin_tpu_torch port-weights clip ViT-B-32.pt checkpoints/clip/vit-b-32
    python -m viscoin_tpu_torch train concept2clip --dataset cub --latent-type gan
    python -m viscoin_tpu_torch dataset-tool --source images/ --dest birds.zip --resolution 256
    python -m viscoin_tpu_torch generate --gan gan --seeds 0-15
    python -m viscoin_tpu_torch style-mixing --gan gan
    python -m viscoin_tpu_torch project --gan gan --target bird.png
    python -m viscoin_tpu_torch fid --gan gan --dataset birds.zip --metric fid --metric ppl
    python -m viscoin_tpu_torch serve --viscoin-pickle-path checkpoints/cub/viscoin-cub
    python -m viscoin_tpu_torch amplify --concept-top-k 4 --outdir figures
    python -m viscoin_tpu_torch logs --logs-path viscoin_100000.jsonl --outdir figures

The commands: ``port-weights`` (``cli/port_weights.py``), ``train classifier
| viscoin | gan | concept2clip`` (``cli/train.py``), ``test classifier`` (``cli/test.py``),
``serve`` and ``export-serving`` (``cli/serve.py``), ``dataset-tool``,
``generate``, ``style-mixing``, ``project``, ``fid``, ``amplify``,
``amplify-pca``, ``concepts``, ``concept-heatmaps``, ``logs`` and
``to-pickle`` (``cli/<name>.py``). Each that computes runs on the card
unless given ``--device cpu``; the analysis commands write their figures as
PNG files to ``--outdir``.
"""

from __future__ import annotations

import argparse
import sys

from viscoin_tpu_torch.cli import amplify as amplify_cmd
from viscoin_tpu_torch.cli import amplify_pca as amplify_pca_cmd
from viscoin_tpu_torch.cli import concept_heatmaps as concept_heatmaps_cmd
from viscoin_tpu_torch.cli import concepts as concepts_cmd
from viscoin_tpu_torch.cli import dataset_tool as dataset_tool_cmd
from viscoin_tpu_torch.cli import fid as fid_cmd
from viscoin_tpu_torch.cli import generate as generate_cmd
from viscoin_tpu_torch.cli import logs as logs_cmd
from viscoin_tpu_torch.cli import port_weights as port_weights_cmd
from viscoin_tpu_torch.cli import project as project_cmd
from viscoin_tpu_torch.cli import serve as serve_cmd
from viscoin_tpu_torch.cli import style_mixing as style_mixing_cmd
from viscoin_tpu_torch.cli import test as test_cmd
from viscoin_tpu_torch.cli import to_pickle as to_pickle_cmd
from viscoin_tpu_torch.cli import train as train_cmd


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m viscoin_tpu_torch",
                                     description="VisCoIN on PyTorch/CUDA.")
    sub = parser.add_subparsers(dest="command", required=True)
    for cmd in (train_cmd, test_cmd, port_weights_cmd, serve_cmd, dataset_tool_cmd,
                generate_cmd, style_mixing_cmd, project_cmd, fid_cmd, to_pickle_cmd,
                amplify_cmd, concepts_cmd, concept_heatmaps_cmd, logs_cmd, amplify_pca_cmd):
        cmd.add_parser(sub)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    args.func(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
