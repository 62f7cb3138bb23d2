"""Datasets, the loader, host transforms and the on-device preprocess."""

from viscoin_tpu_torch.data.datasets import (
    CUB_200_2011,
    FunnyBirds,
    ImageFolderDataset,
    LabeledCUB,
    SyntheticDataset,
)

__all__ = ["CUB_200_2011", "FunnyBirds", "ImageFolderDataset", "LabeledCUB", "SyntheticDataset"]
