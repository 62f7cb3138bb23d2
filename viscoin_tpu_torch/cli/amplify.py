"""The ``amplify`` command: amplify the concepts of test images.

Counterpart of ``viscoin_tpu/cli/amplify.py``, with its options, plus
``--device`` (the card by default) and ``--outdir``, where the figure goes
(``amplify.png``; the JAX command shows it in a window):

    python -m viscoin_tpu_torch amplify --dataset synthetic --concept-top-k 4

Each image runs its 2M + 1 variants as one generator + classifier pass
(``eval/viscoin.py::amplify_concepts``). The images (``--image-indices``, or
5 drawn at random) and the random concepts come from an unseeded generator,
as in the JAX command.
"""

from __future__ import annotations

import argparse

import numpy as np

from viscoin_tpu_torch.cli.utils import (
    add_dataset_option,
    add_device_option,
    add_outdir_option,
    add_viscoin_pickle_option,
)

N_SAMPLES = 5
MULTIPLIERS = [0.0, 1.0, 2.0, 4.0]


def add_parser(subparsers) -> None:
    p = subparsers.add_parser("amplify", help="Amplify the concepts of random images from a "
                                              "dataset (showcase).")
    add_viscoin_pickle_option(p)
    add_device_option(p)
    p.add_argument("--concept-threshold", type=float, default=None,
                   help="Concept activation threshold in [-1, 1] (prefer 0.2); exclusive with "
                        "concept-top-k")
    p.add_argument("--concept-top-k", type=int, default=None,
                   help="Amount of most activated concepts to amplify; exclusive with "
                        "concept-threshold")
    p.add_argument("--concept-indices", default=None,
                   help="Indices of the concepts to amplify simultaneously: eg. 1,2,3")
    p.add_argument("--image-indices", default=None,
                   help="Indices of the images to amplify: eg. 1,2,3")
    add_dataset_option(p)
    add_outdir_option(p)
    p.set_defaults(func=amplify)


def concept_selection(args: argparse.Namespace):
    if args.concept_indices is not None:
        return {"method": "indices", "indices": [int(i) for i in args.concept_indices.split(",")]}
    if args.concept_threshold is not None:
        return {"method": "threshold", "threshold": args.concept_threshold}
    if args.concept_top_k is not None:
        return {"method": "top_k", "k": args.concept_top_k}
    raise ValueError("You must provide either concept-threshold or concept-top-k")


def amplify_images(models, test_ds, indices, selection, multipliers, rng):
    """(originals: preprocessed (3, H, W) tensors, amplified: per image the
    list of HWC arrays, one per multiplier)."""
    import torch

    from viscoin_tpu_torch.data.transforms import device_preprocess
    from viscoin_tpu_torch.eval.viscoin import amplify_concepts, make_amplify_fns

    device = next(models.parameters()).device
    fns = make_amplify_fns(models)
    originals, amplified = [], []
    for i in indices:
        u8 = torch.from_numpy(np.ascontiguousarray(test_ds[int(i)][0][None])).to(device)
        x = device_preprocess(u8)[0]
        originals.append(x)
        res = amplify_concepts(x, models, selection, multipliers, rng=rng, fns=fns)
        amplified.append(res.amplified_images)
    return originals, amplified


def amplify(args: argparse.Namespace) -> None:
    from viscoin_tpu_torch.cli.utils import card_or_cpu
    from viscoin_tpu_torch.data.utils import get_datasets
    from viscoin_tpu_torch.utils.checkpoints import load_viscoin_bundle
    from viscoin_tpu_torch.utils.plotting import plot_amplified_images_batch

    device = card_or_cpu("amplify", args.device)
    models = load_viscoin_bundle(args.viscoin_pickle_path, device=device)
    _, test_ds = get_datasets(args.dataset)
    rng = np.random.default_rng()
    if args.image_indices is not None:
        indices = [int(i) for i in args.image_indices.split(",")]
    else:
        indices = rng.choice(len(test_ds), N_SAMPLES, replace=False)
    selection = concept_selection(args)
    originals, amplified = amplify_images(models, test_ds, indices, selection, MULTIPLIERS, rng)
    path = plot_amplified_images_batch(originals, amplified, MULTIPLIERS, outdir=args.outdir)
    print(f"amplified images {[int(i) for i in indices]}: wrote {path}")
