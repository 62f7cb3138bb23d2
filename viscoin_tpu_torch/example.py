"""Showcase the models in action: the port's counterpart of the root ``example.py``.

    python -m viscoin_tpu_torch.example                 # on the card
    python -m viscoin_tpu_torch.example --device cpu    # on the CPU (slow at 256²)

The canonical forward pass: classifier f -> hidden[-3:] -> Psi -> (Phi,
Phi') -> Theta logits, and G(z1=Phi, z2=Phi', noise_mode="const") -> the
reconstructed image. It runs with random weights from a seed (no downloads)
on two images: CUB's first two training images where ``VISCOIN_DATA_DIR``
holds CUB_200_2011, else synthetic ones. It writes the two reconstructions
as ``example_output_{0,1}.png`` with PIL (the JAX example draws them with
matplotlib). The sizes are :func:`run`'s arguments, the JAX example's
values by default.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def run(n_classes: int = 200, n_concepts: int = 256, img_resolution: int = 256,
        channel_base: int = 16384, channel_max: int = 512, device="cuda", seed: int = 0,
        outdir: str = ".") -> dict:
    """The forward pass on two images; writes the two PNGs into ``outdir``
    and returns the outputs (numpy) and the PNGs' paths."""
    from PIL import Image

    from viscoin_tpu_torch.cli.utils import card_or_cpu
    from viscoin_tpu_torch.data.datasets import CUB_200_2011, SyntheticDataset
    from viscoin_tpu_torch.data.transforms import device_preprocess
    from viscoin_tpu_torch.models.bundle import default_models
    from viscoin_tpu_torch.train.losses import concept_regularization_loss
    from viscoin_tpu_torch.utils.images import from_torch

    device = card_or_cpu("example", device)
    models = default_models(n_classes=n_classes, n_concepts=n_concepts,
                            img_resolution=img_resolution, channel_base=channel_base,
                            channel_max=channel_max, device=device, seed=seed).eval()
    try:
        dataset = CUB_200_2011(mode="train")
    except FileNotFoundError:
        dataset = SyntheticDataset(n=2, n_classes=n_classes, image_size=img_resolution)
    batch_u8 = np.stack([dataset[0][0], dataset[1][0]])
    batch = device_preprocess(torch.from_numpy(batch_u8).to(device))
    print("Batch:", tuple(batch.shape))

    with torch.no_grad():
        classes, hidden = models.classify(batch)
        concept_space, gan_helper_space = models.extract_concepts(hidden)
        expl_classes = models.explain(concept_space)
        fake_img = models.reconstruct(concept_space, gan_helper_space, noise_mode="const")
        reg = float(concept_regularization_loss(concept_space))
    print("Classifier classes:", tuple(classes.shape))
    print("Concept space:", tuple(concept_space.shape))  # (2, 256, 3, 3) NCHW
    print("Concept regularization loss:", reg)
    print("Explainer classes:", tuple(expl_classes.shape))
    print("Fake image:", tuple(fake_img.shape))

    images = from_torch(fake_img)
    print("Images:", images.shape)
    os.makedirs(outdir, exist_ok=True)
    paths = []
    for i in range(2):
        path = os.path.join(outdir, f"example_output_{i}.png")
        Image.fromarray(np.round(images[i] * 255).astype(np.uint8)).save(path)
        paths.append(path)
    print("Saved example_output_{0,1}.png")
    return {"classes": classes.float().cpu().numpy(),
            "concept_space": concept_space.float().cpu().numpy(),
            "expl_classes": expl_classes.float().cpu().numpy(), "images": images,
            "concept_regularization_loss": reg, "paths": paths}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="The torch device to run on: cuda (default) or cpu")
    parser.add_argument("--outdir", default=".", help="Where the two PNGs go (default .)")
    args = parser.parse_args(argv)
    run(device=args.device, outdir=args.outdir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
