"""The ``project`` command: invert a target image into the generator's W space.

Counterpart of ``viscoin_tpu/cli/project.py`` (stylegan2-ada's
``projector.py`` analogue; the semantics are ``eval/projection.py``'s):

    python -m viscoin_tpu_torch project --gan checkpoints/cub/gan-cub --target bird.png

The target is decoded with the GAN geometry (``host_gan_transform``) at the
generator's resolution. Written to ``--outdir``: ``proj.png`` (the final
render, with the optimised noise buffers), ``target.png`` (the target as
optimised against) and ``projected_w.npz`` (``w`` (num_ws, w_dim), ``losses``
(steps,)). Needs the LPIPS weights at ``checkpoints/lpips-vgg``.
"""

from __future__ import annotations

import argparse

from viscoin_tpu_torch.cli.utils import add_device_option, add_gan_option, existing_path


def add_parser(subparsers) -> argparse.ArgumentParser:
    p = subparsers.add_parser("project", help="Project a target image into W (writes proj.png "
                                              "+ projected_w.npz).")
    add_gan_option(p)
    p.add_argument("--target", dest="target_path", type=existing_path, required=True,
                   help="Target image file (any size; decoded with the GAN geometry at the "
                        "generator's resolution)")
    p.add_argument("--steps", dest="num_steps", type=int, default=1000,
                   help="Optimization steps (default 1000)")
    p.add_argument("--w-plus", action="store_true",
                   help="Optimize a per-layer W+ latent instead of one shared w")
    p.add_argument("--seed", type=int, default=0, help="Seed of the projection's draws")
    p.add_argument("--outdir", default="proj", help="Output directory (default proj)")
    add_device_option(p)
    p.set_defaults(func=project, parser=p)
    return p


def project(args: argparse.Namespace) -> None:
    import os

    import numpy as np
    from PIL import Image

    from viscoin_tpu_torch.cli.generate import save_png
    from viscoin_tpu_torch.cli.utils import card_or_cpu, load_generator, require_lpips
    from viscoin_tpu_torch.data.transforms import host_gan_transform
    from viscoin_tpu_torch.eval.projection import project_image

    device = card_or_cpu("project", args.device)
    lpips = require_lpips(args.parser, "project (the projection loss is perceptual)", device)
    generator = load_generator(args.gan_path, device)
    res = generator.img_resolution
    channels = generator.synthesis.img_channels
    # PIL's transforms take 2-D grayscale; the channel axis goes on after.
    with Image.open(args.target_path) as img:
        raw = np.asarray(img.convert("RGB" if channels == 3 else "L"))
    target_u8 = host_gan_transform(raw, size=res)
    if target_u8.ndim == 2:
        target_u8 = target_u8[..., None]
    target = target_u8.astype(np.float32) / 127.5 - 1.0

    w, losses, render = project_image(generator, lpips, target, num_steps=args.num_steps,
                                      w_plus=args.w_plus, seed=args.seed)
    os.makedirs(args.outdir, exist_ok=True)
    np.savez(os.path.join(args.outdir, "projected_w.npz"), w=w, losses=losses)
    save_png(render, os.path.join(args.outdir, "proj.png"))
    save_png(target_u8, os.path.join(args.outdir, "target.png"))
    print(f"projected in {args.num_steps} steps: loss {float(losses[0]):.4f} -> "
          f"{float(losses[-1]):.4f}; wrote {args.outdir}/proj.png, target.png, projected_w.npz"
          + (" (W+)" if args.w_plus else ""))
