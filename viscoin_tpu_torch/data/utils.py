"""Dataset registry and checkpoint path conventions.

Counterpart of ``viscoin_tpu/data/utils.py``. A dataset is a registry name
("cub", "funnybirds", "synthetic"), a directory with the
``{root}/{train|test}/{class}/{image}`` layout, or a StyleGAN training zip
(``data/stylegan_zip.py``, train-only). Checkpoints follow the JAX
package's paths (``checkpoints/{dataset}/classifier-{dataset}`` ...), each a
directory in the npz bundle layout of ``utils/checkpoints.py``.
"""

from __future__ import annotations

import os
from typing import Literal

from viscoin_tpu_torch.data.datasets import (
    CUB_200_2011,
    FunnyBirds,
    ImageFolderDataset,
    SyntheticDataset,
)
from viscoin_tpu_torch.data.loader import DataLoader

DATASET_CLASSES = {"cub": 200, "funnybirds": 50, "synthetic": 10}

DEFAULT_CHECKPOINTS = {
    dataset: {
        "classifier": f"checkpoints/{dataset}/classifier-{dataset}",
        "gan": f"checkpoints/{dataset}/gan-{dataset}",
        "gan_adapted": f"checkpoints/{dataset}/gan-adapted-{dataset}",
        "viscoin": f"checkpoints/{dataset}/viscoin-{dataset}",
    }
    for dataset in DATASET_CLASSES
}
DEFAULT_VISCOIN = DEFAULT_CHECKPOINTS["cub"]["viscoin"]

_CLASSES = {"cub": CUB_200_2011, "funnybirds": FunnyBirds, "synthetic": SyntheticDataset}
DATASET_NAMES = tuple(DATASET_CLASSES)


def dataset_key(name: str) -> str:
    """The short name of a dataset for checkpoint and log paths: the registry
    name, or the basename of a folder root or a training zip."""
    if name in DATASET_CLASSES:
        return name
    base = os.path.basename(os.path.normpath(name))
    return base[:-4] if base.lower().endswith(".zip") else base


def default_checkpoints(name: str) -> dict[str, str]:
    """The checkpoint paths of a registry name or a folder dataset."""
    key = dataset_key(name)
    if key in DEFAULT_CHECKPOINTS:
        return DEFAULT_CHECKPOINTS[key]
    return {kind: f"checkpoints/{key}/{pref}-{key}"
            for kind, pref in (("classifier", "classifier"), ("gan", "gan"),
                               ("gan_adapted", "gan-adapted"), ("viscoin", "viscoin"))}


def get_datasets(name: str, transform: Literal["train", "test", "gan"] | None = None,
                 train_only: bool = False, **kwargs):
    """(train, test) datasets; ``transform`` overrides each split's default
    geometry, and ``train_only`` skips the test split (None)."""
    if name in _CLASSES:
        cls = _CLASSES[name]
        train = cls(mode="train", transform=transform, **kwargs)
        return train, (None if train_only else cls(mode="test", transform=transform, **kwargs))
    if os.path.isdir(name):
        def split(mode):
            return ImageFolderDataset(mode=mode, transform=transform, root=name, **kwargs)

        return split("train"), (None if train_only else split("test"))
    if os.path.isfile(name) and name.lower().endswith(".zip"):
        # A StyleGAN training zip is the training set itself: train-only.
        from viscoin_tpu_torch.data.stylegan_zip import StyleGANZipDataset

        if not train_only:
            raise ValueError(f"{name} is a StyleGAN training zip — it has no test split (use "
                             "it with `train gan` / `fid`, which are train-only)")
        return StyleGANZipDataset(name, mode="train", transform=transform, **kwargs), None
    raise ValueError(f"unknown dataset {name!r}: expected one of {sorted(DATASET_CLASSES)}, a "
                     "directory path with a {root}/{train|test}/{class}/{image} layout, or a "
                     "StyleGAN training .zip (train-only)")


def get_dataloaders(name: str, batch_size: int,
                    transform: Literal["train", "test", "gan"] | None = None,
                    shuffle: bool = True, shard: tuple[int, int] = (0, 1), **kwargs):
    """(train, test) loaders of ``batch_size``; ``shard=(rank, world)``
    makes them yield a data-parallel rank's slice of every global batch,
    the test loader's ragged last batch padded (its padding masked) rather
    than dropped."""
    train, test = get_datasets(name, transform, **kwargs)
    return (DataLoader(train, batch_size, shuffle=shuffle, shard=shard),
            DataLoader(test, batch_size, shuffle=shuffle, shard=shard, pad_final=shard[1] > 1))
