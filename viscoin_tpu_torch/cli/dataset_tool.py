"""The ``dataset-tool`` command: pack images into a StyleGAN training zip.

Counterpart of ``viscoin_tpu/cli/dataset_tool.py`` (the stylegan2-ada
``dataset_tool.py`` analogue), with its options and refusals:

    python -m viscoin_tpu_torch dataset-tool --source images/ --dest birds.zip --resolution 256

``--source`` is an image directory (labels from top-level class folders),
an existing training zip (re-packed) or a registry dataset name. The archive
trains with ``train gan --dataset birds.zip`` and measures with ``fid
--dataset birds.zip``, here, in the JAX package and upstream.
"""

from __future__ import annotations

import argparse


def add_parser(subparsers) -> argparse.ArgumentParser:
    p = subparsers.add_parser("dataset-tool", help="Pack images into a StyleGAN training zip "
                                                   "(stylegan2-ada layout).")
    p.add_argument("--source", required=True,
                   help="Image directory (labels from top-level class folders), an existing "
                        "training zip (re-packed), or a registry dataset name (cub / synthetic)")
    p.add_argument("--dest", required=True, help="Output .zip path.")
    p.add_argument("--resolution", type=int, default=None,
                   help="Output resolution (square). Default: keep stored sizes (requires a "
                        "uniform square source).")
    p.add_argument("--transform", choices=["center-crop", "none"], default="center-crop",
                   help="Geometry applied when --resolution is set: full-short-side center crop "
                        "+ resize, or refuse non-matching images (default center-crop)")
    p.add_argument("--max-images", type=int, default=None, help="Pack only the first N images.")
    p.set_defaults(func=dataset_tool, parser=p)
    return p


def dataset_tool(args: argparse.Namespace) -> None:
    from viscoin_tpu_torch.data.stylegan_zip import pack_stylegan_zip

    try:
        count, res = pack_stylegan_zip(args.source, args.dest, resolution=args.resolution,
                                       transform=args.transform, max_images=args.max_images)
    except (ValueError, FileNotFoundError) as e:
        args.parser.error(str(e))
    if res & (res - 1):
        print(f"WARNING: resolution {res} is not a power of two — StyleGAN training requires "
              "one (pass --resolution).")
    print(f"packed {count} images at {res}x{res} into {args.dest}")
