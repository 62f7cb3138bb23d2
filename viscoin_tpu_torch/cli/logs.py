"""The ``logs`` command: plot the curves of a training run's jsonl log.

Counterpart of ``viscoin_tpu/cli/logs.py``, with its option, plus
``--outdir``, where the figures go (the JAX command shows them):

    python -m viscoin_tpu_torch logs --logs-path viscoin_100000.jsonl

Every schema the JAX command reads: ``train viscoin``'s (``train_*`` and
``test_*`` keys: ``training_losses.png``, ``testing_losses.png``,
``preds_overlap.png``), ``train gan``'s (``gan_logs.png``), and the
classifier's and Concept2CLIP's per-epoch scalars (``training_curves.png``).
Blank lines are skipped and a truncated last line (a run killed while
writing) is dropped; a bad line anywhere else raises. The command reads and
draws on the host only, so it has no ``--device`` (as ``dataset-tool``).
"""

from __future__ import annotations

import argparse
import json

from viscoin_tpu_torch.cli.utils import add_outdir_option


def add_parser(subparsers) -> None:
    p = subparsers.add_parser("logs", help="Parse a training jsonl log file and plot the "
                                           "losses and metrics.")
    p.add_argument("--logs-path", required=True, help="The path to the logs file")
    add_outdir_option(p)
    p.set_defaults(func=logs)


def read_records(logs_path: str) -> list[dict]:
    """The records of a jsonl log, skipping blank lines and a truncated
    last line; a bad line elsewhere raises ValueError with its number."""
    lines: list[tuple[int, str]] = []
    with open(logs_path) as f:
        for i, line in enumerate(f, 1):
            if line.strip():
                lines.append((i, line))
    records = []
    for pos, (i, line) in enumerate(lines):
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError:
            if pos == len(lines) - 1:
                continue  # the partial last line of a killed run
            raise ValueError(f"{logs_path}:{i}: unparseable jsonl line") from None
    return records


def split_viscoin_records(records: list[dict]):
    """(TrainingResults, TestingResults) per record of a ``train viscoin`` log."""
    from viscoin_tpu_torch.utils.types import TestingResults, TrainingResults

    training, testing = [], []
    for data in records:
        train_kwargs, test_kwargs = {}, {}
        for key, value in data.items():
            if key.startswith("train_"):
                train_kwargs[key[len("train_"):]] = value
            elif key.startswith("test_"):
                test_kwargs[key[len("test_"):]] = value
            else:
                raise ValueError(f"Unknown key: {key}")
        training.append(TrainingResults(**train_kwargs))
        testing.append(TestingResults(**test_kwargs))
    return training, testing


def plot_gan_logs(records: list[dict], outdir: str) -> str:
    """Adversarial losses, and the regularisers and FID, over iterations
    (records differ in their keys: each curve takes the records that have
    its key)."""
    from viscoin_tpu_torch.utils.plotting import new_figure, save_figure

    fig, (ax1, ax2) = new_figure(1, 2, figsize=(12, 4))
    for key in ("g_loss", "d_loss"):
        pts = [(r["iteration"], r[key]) for r in records if key in r]
        ax1.plot([p[0] for p in pts], [p[1] for p in pts], label=key)
    ax1.set_xlabel("iteration"), ax1.legend(), ax1.set_title("adversarial losses")
    for key in ("r1", "pl_lengths", "pl_mean", "ada_p", "fid"):
        if any(key in r for r in records):
            pts = [(r["iteration"], r[key]) for r in records if key in r]
            ax2.plot([p[0] for p in pts], [p[1] for p in pts], label=key)
    ax2.set_xlabel("iteration"), ax2.legend(), ax2.set_title("regularizers / fid")
    fig.tight_layout()
    return save_figure(fig, outdir, "gan_logs")


def plot_scalar_logs(records: list[dict], title: str, outdir: str) -> str:
    """Per-epoch curves of every numeric key (the union over the records)."""
    from viscoin_tpu_torch.utils.plotting import new_figure, save_figure

    keys: list[str] = []
    for r in records:
        keys += [k for k in r if k not in keys and isinstance(r[k], (int, float))]
    fig, ax = new_figure(figsize=(8, 4))
    for key in keys:
        pts = [(i, r[key]) for i, r in enumerate(records) if key in r]
        ax.plot([p[0] for p in pts], [p[1] for p in pts], label=key)
    ax.set_xlabel("epoch"), ax.legend(), ax.set_title(title)
    fig.tight_layout()
    return save_figure(fig, outdir, "training_curves")


def plot_logs(records: list[dict], outdir: str) -> list[str]:
    """The figures of a log, by its schema (sniffed over every record: the
    first record of a run depends on its cadences)."""
    from viscoin_tpu_torch.utils.types import TestingResults, TrainingResults

    if any("g_loss" in r or "fid" in r for r in records):  # train gan
        return [plot_gan_logs(records, outdir)]
    if any("matching_accuracy" in r or "train_accuracy" in r for r in records):
        return [plot_scalar_logs(records, "training curves", outdir)]
    training, testing = split_viscoin_records(records)
    return [TrainingResults.plot_losses(training, outdir),
            TestingResults.plot_losses(testing, outdir),
            TestingResults.plot_preds_overlap(testing, outdir)]


def logs(args: argparse.Namespace) -> None:
    records = read_records(args.logs_path)
    for path in plot_logs(records, args.outdir):
        print(f"wrote {path}")
