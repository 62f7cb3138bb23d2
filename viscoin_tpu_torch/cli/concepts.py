"""The ``concepts`` command: concept distribution analytics over the test set.

Counterpart of ``viscoin_tpu/cli/concepts.py``, with its options (the
``concept_results.pkl`` cache in the working directory, ``--force`` to
recompute), plus ``--device`` (the card by default) and ``--outdir``, where
the five figures go (the JAX command shows them):

    python -m viscoin_tpu_torch concepts --dataset synthetic --batch-size 32
"""

from __future__ import annotations

import argparse
import os
import pickle

from viscoin_tpu_torch.cli.utils import (
    add_dataset_option,
    add_device_option,
    add_outdir_option,
    add_viscoin_pickle_option,
)

CACHE = "concept_results.pkl"


def add_parser(subparsers) -> None:
    p = subparsers.add_parser("concepts", help="Analyse the distribution of concepts across "
                                               "the test dataset, and how well they separate "
                                               "classes.")
    add_viscoin_pickle_option(p)
    p.add_argument("--batch-size", type=int, default=None,
                   help="The batch size to use for testing (default 32)")
    add_device_option(p)
    p.add_argument("--force", action="store_true",
                   help="Recompute the concepts through the dataset, even if cached")
    add_dataset_option(p)
    add_outdir_option(p)
    p.set_defaults(func=concepts)


def concepts(args: argparse.Namespace) -> None:
    from viscoin_tpu_torch.cli.utils import card_or_cpu
    from viscoin_tpu_torch.data.loader import DataLoader
    from viscoin_tpu_torch.data.utils import get_datasets
    from viscoin_tpu_torch.eval.concepts import test_concepts
    from viscoin_tpu_torch.utils.checkpoints import load_viscoin_bundle

    device = card_or_cpu("concepts", args.device)
    if args.force or not os.path.isfile(CACHE):
        _, test_ds = get_datasets(args.dataset)
        loader = DataLoader(test_ds, batch_size=args.batch_size or 32, shuffle=False)
        models = load_viscoin_bundle(args.viscoin_pickle_path, device=device)
        results = test_concepts(models, loader, test_ds.N_CLASSES)
        with open(CACHE, "wb") as f:
            pickle.dump(results, f)
    else:
        with open(CACHE, "rb") as f:  # this command's own cache
            results = pickle.load(f)
    results.print_accuracies()
    for path in results.plot_all(args.outdir):
        print(f"wrote {path}")
