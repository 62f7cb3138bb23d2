"""The ``generate`` command: images from a trained or ported generator.

Counterpart of ``viscoin_tpu/cli/generate.py`` (the stylegan2-ada
``generate.py`` analogue):

    python -m viscoin_tpu_torch generate --gan checkpoints/cub/gan-cub --seeds 0-15

One ``seed{N:04d}.png`` per seed. Each image is a function of its seed
alone: z is drawn by a CPU ``torch.Generator`` seeded with the seed
(:func:`seed_latents`), so it is the same on every device and at every batch
position; the random streams differ from JAX's by design (PARITY.md,
divergence 7). ``--trunc`` truncates towards the exported w_avg,
``--noise-mode`` picks the synthesis noise ("random" is drawn per batch, from
the batch's first seed and offset). Batches are padded to ``--batch-size``
with the last seed, so every batch has one shape. The synthesis runs under
cuDNN's deterministic algorithms (:func:`deterministic_cudnn`), so a seed
renders the same PNG in every run on the card.
"""

from __future__ import annotations

import argparse

import torch

from viscoin_tpu_torch.cli.utils import add_device_option, add_gan_option
from viscoin_tpu_torch.utils.cudnn import deterministic_cudnn


def parse_seeds(spec: str, flag: str = "--seeds") -> list[int]:
    """'0-3,7,10-11' -> [0, 1, 2, 3, 7, 10, 11] (upstream's --seeds syntax);
    ``flag`` names the option in the error (ValueError)."""
    out: list[int] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        lo, sep, hi = part.partition("-")
        try:
            if sep:
                a, b = int(lo), int(hi)
                if b < a:
                    raise ValueError
                out.extend(range(a, b + 1))
            else:
                out.append(int(part))
        except ValueError:
            raise ValueError(f"{flag} {spec!r}: expected comma-separated ints/ranges like "
                             "'0-15,20,33'") from None
    if not out:
        raise ValueError(f"{flag} {spec!r}: no seeds parsed")
    return out


def seed_latents(seeds: list[int], z_dim: int) -> torch.Tensor:
    """(len(seeds), z_dim) standard normal latents on the CPU, row i drawn
    by a generator seeded ``seeds[i]``."""
    return torch.stack([torch.randn(z_dim, generator=torch.Generator().manual_seed(int(s)))
                        for s in seeds])


def to_u8(img: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) in [-1, 1] -> (B, H, W, C) uint8 on the host, truncated
    as the JAX commands' ``astype(uint8)``."""
    u8 = ((img.float() + 1.0) * 127.5).clamp(0.0, 255.0).to(torch.uint8)
    return u8.permute(0, 2, 3, 1).cpu()


def save_png(arr, path: str) -> None:
    from PIL import Image

    arr = arr.numpy() if isinstance(arr, torch.Tensor) else arr
    Image.fromarray(arr[..., 0] if arr.shape[-1] == 1 else arr).save(path)


def noise_generator(device, first_seed: int, offset: int) -> torch.Generator:
    """The synthesis noise stream of one batch (used by ``--noise-mode
    random`` only)."""
    from viscoin_tpu_torch.train.viscoin import fold_seed

    return torch.Generator(device=device).manual_seed(fold_seed(first_seed, offset))


def add_parser(subparsers) -> argparse.ArgumentParser:
    p = subparsers.add_parser("generate", help="Render seed{N}.png images from a (trained or "
                                               "ported) generator.")
    add_gan_option(p)
    p.add_argument("--seeds", default="0-15",
                   help="Comma-separated seeds/ranges (e.g. '0-15,20,33'); one image per seed, "
                        "each a function of its seed alone (default 0-15)")
    p.add_argument("--trunc", dest="truncation_psi", type=float, default=1.0,
                   help="Truncation psi toward the exported w_avg (1.0 = off)")
    p.add_argument("--noise-mode", choices=["const", "random", "none"], default="const",
                   help="Per-pixel synthesis noise (default const)")
    p.add_argument("--outdir", default="out", help="Output directory (default out)")
    p.add_argument("--batch-size", type=int, default=16, help="Images per batch (default 16)")
    add_device_option(p)
    p.set_defaults(func=generate, parser=p)
    return p


@torch.no_grad()
def generate(args: argparse.Namespace) -> None:
    import os

    from viscoin_tpu_torch.cli.utils import card_or_cpu, load_generator

    try:
        seed_list = parse_seeds(args.seeds)
    except ValueError as e:
        args.parser.error(str(e))
    device = card_or_cpu("generate", args.device)
    generator = load_generator(args.gan_path, device)
    bs = args.batch_size
    os.makedirs(args.outdir, exist_ok=True)
    for s in range(0, len(seed_list), bs):
        batch = seed_list[s: s + bs]
        padded = batch + [batch[-1]] * (bs - len(batch))
        z = seed_latents(padded, generator.z_dim).to(device)
        with deterministic_cudnn():
            img = generator(z, truncation_psi=args.truncation_psi, noise_mode=args.noise_mode,
                            generator=noise_generator(device, batch[0], s))
        for seed, arr in zip(batch, to_u8(img)[: len(batch)]):
            save_png(arr, os.path.join(args.outdir, f"seed{seed:04d}.png"))
    print(f"wrote {len(seed_list)} images to {args.outdir} (trunc={args.truncation_psi}, "
          f"noise={args.noise_mode})")
