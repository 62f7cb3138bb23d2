"""The ``style-mixing`` command: a coarse/fine style-mixing grid.

Counterpart of ``viscoin_tpu/cli/style_mixing.py`` (the stylegan2-ada
``style_mixing.py`` analogue):

    python -m viscoin_tpu_torch style-mixing --gan checkpoints/cub/gan-cub --rows 85,100,75

Each seed's latent is that of ``generate`` (:func:`seed_latents`); the
mapping runs once over the distinct seeds (with ``--trunc``). A grid cell
(r, c) takes the column seed's style vectors at the ``--col-styles`` layers
and the row seed's elsewhere: a masked select over the style layers. The
pure row and column images are the self-pairs (r, r) and (c, c), which any
mask leaves as they are. Every cell goes through one padded synthesis batch
shape, under cuDNN's deterministic algorithms as in ``generate``. Written:
``{row}-{col}.png`` per cell and ``grid.png``, whose top row and left column
hold the column and row images, with a black corner.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from viscoin_tpu_torch.cli.generate import (
    noise_generator,
    parse_seeds,
    save_png,
    seed_latents,
    to_u8,
)
from viscoin_tpu_torch.cli.utils import add_device_option, add_gan_option
from viscoin_tpu_torch.utils.cudnn import deterministic_cudnn


def add_parser(subparsers) -> argparse.ArgumentParser:
    p = subparsers.add_parser("style-mixing", help="Render a style-mixing grid (writes "
                                                   "{row}-{col}.png + grid.png).")
    add_gan_option(p)
    p.add_argument("--rows", dest="row_spec", default="85,100,75",
                   help="Row seeds (comma-separated ints/ranges; default 85,100,75)")
    p.add_argument("--cols", dest="col_spec", default="55,821,1789",
                   help="Column seeds (default 55,821,1789)")
    p.add_argument("--col-styles", dest="style_spec", default="0-6",
                   help="Style-layer indices the column seed overrides (default 0-6 = "
                        "coarse/mid)")
    p.add_argument("--trunc", dest="truncation_psi", type=float, default=1.0,
                   help="Truncation psi toward the exported w_avg (1.0 = off)")
    p.add_argument("--noise-mode", choices=["const", "random", "none"], default="const",
                   help="Per-pixel synthesis noise (default const)")
    p.add_argument("--outdir", default="mix", help="Output directory (default mix)")
    p.add_argument("--batch-size", type=int, default=16, help="Cells per batch (default 16)")
    add_device_option(p)
    p.set_defaults(func=style_mixing, parser=p)
    return p


def mix_styles(ws_all: torch.Tensor, row_idx: torch.Tensor, col_idx: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """(N, num_ws, w_dim) mapped seeds -> (B, num_ws, w_dim): the column
    seed's styles where ``mask`` (num_ws,) is set, the row seed's elsewhere."""
    return torch.where(mask[None, :, None], ws_all[col_idx], ws_all[row_idx])


@torch.no_grad()
def style_mixing(args: argparse.Namespace) -> None:
    import os

    from PIL import Image

    from viscoin_tpu_torch.cli.utils import card_or_cpu, load_generator

    try:
        row_seeds = parse_seeds(args.row_spec, flag="--rows")
        col_seeds = parse_seeds(args.col_spec, flag="--cols")
        col_styles = parse_seeds(args.style_spec, flag="--col-styles")
    except ValueError as e:
        args.parser.error(str(e))
    device = card_or_cpu("style-mixing", args.device)
    generator = load_generator(args.gan_path, device)
    num_ws = generator.synthesis.num_ws
    bad = [s for s in col_styles if not 0 <= s < num_ws]
    if bad:
        args.parser.error(f"--col-styles {args.style_spec!r}: indices {bad} out of range for "
                          f"this generator's {num_ws} style layers")
    mask = torch.zeros(num_ws, dtype=torch.bool)
    mask[col_styles] = True
    mask = mask.to(device)

    seeds = sorted(set(row_seeds) | set(col_seeds))
    idx = {s: i for i, s in enumerate(seeds)}
    ws_all = generator.mapping(seed_latents(seeds, generator.z_dim).to(device),
                               truncation_psi=args.truncation_psi)

    # The mixed pairs, then the pure row and column images as self-pairs,
    # each once.
    pairs = list(dict.fromkeys([(r, c) for r in row_seeds for c in col_seeds]
                               + [(r, r) for r in row_seeds] + [(c, c) for c in col_seeds]))
    bs = args.batch_size
    images: dict[tuple[int, int], np.ndarray] = {}
    for s in range(0, len(pairs), bs):
        batch = pairs[s: s + bs]
        padded = batch + [batch[-1]] * (bs - len(batch))
        rows = torch.tensor([idx[r] for r, _ in padded], device=device)
        cols = torch.tensor([idx[c] for _, c in padded], device=device)
        with deterministic_cudnn():
            img = generator.synthesis(mix_styles(ws_all, rows, cols, mask),
                                      noise_mode=args.noise_mode,
                                      generator=noise_generator(device, batch[0][0], s))
        images.update(zip(batch, to_u8(img).numpy()[: len(batch)]))

    os.makedirs(args.outdir, exist_ok=True)
    for (r, c), img in images.items():
        save_png(img, os.path.join(args.outdir, f"{r}-{c}.png"))
    res = generator.img_resolution
    channels = generator.synthesis.img_channels
    canvas = Image.new("RGB" if channels == 3 else "L",
                       (res * (len(col_seeds) + 1), res * (len(row_seeds) + 1)), "black")
    for ri, r in enumerate([None] + row_seeds):
        for ci, c in enumerate([None] + col_seeds):
            if r is None and c is None:
                continue
            key = (c, c) if r is None else ((r, r) if c is None else (r, c))
            arr = images[key]
            canvas.paste(Image.fromarray(arr[..., 0] if arr.shape[-1] == 1 else arr),
                         (res * ci, res * ri))
    canvas.save(os.path.join(args.outdir, "grid.png"))
    print(f"wrote {len(images)} images + grid.png to {args.outdir} "
          f"(col-styles={sorted(col_styles)}, trunc={args.truncation_psi})")
