"""The ``fid`` command: offline GAN metrics (FID, KID, precision/recall, PPL).

Counterpart of ``viscoin_tpu/cli/fid.py`` (stylegan2-ada's
``calc_metrics.py`` analogue), with its options and refusals:

    python -m viscoin_tpu_torch fid --gan checkpoints/cub/gan-cub --dataset birds.zip \\
        --metric fid --metric kid --metric pr --metric ppl

The generator is rebuilt from its weights. FID, KID and precision/recall
share one pass over the same detector features: the real side is one
deterministic pass over the TRAIN split with ``transform="gan"`` at the
generator's resolution (folders and zips decode at it; a registry dataset
must match it), the fake side ``--samples`` EMA-generator samples, batch j
seeded ``fold_seed(--seed, j)`` (``train/gan.py::accumulate_fake_fid_stats``).
The detector is ``--fid-detector`` or ``checkpoints/inception``. PPL
(``eval/ppl.py``) needs no dataset or detector, only LPIPS weights
(``checkpoints/lpips-vgg``, or ``--lpips-detector``: another ported
directory, or the NVlabs ``vgg16.pt`` for upstream's distance). Prints one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import os

from viscoin_tpu_torch.cli.utils import (
    add_device_option,
    add_gan_option,
    dataset_arg,
    existing_path,
)


def add_parser(subparsers) -> argparse.ArgumentParser:
    p = subparsers.add_parser("fid", help="Offline FID/KID/PR/PPL of a (trained or ported) "
                                          "generator.")
    p.add_argument("--dataset", type=dataset_arg, default="cub",
                   help="The real side: cub | synthetic | a directory path (image-folder "
                        "layout) | a training .zip")
    add_device_option(p)
    add_gan_option(p)
    p.add_argument("--fid-detector", dest="fid_detector_path", type=existing_path, default=None,
                   help="FID feature detector (see `train --fid-detector`). Default: "
                        "checkpoints/inception")
    p.add_argument("--samples", type=int, default=8192,
                   help="Samples per side (default 8192; upstream's fid50k_full uses 50000)")
    p.add_argument("--batch-size", type=int, default=64, help="Batch size (default 64)")
    p.add_argument("--seed", type=int, default=0, help="Seed of the fake side and of PPL")
    p.add_argument("--lpips-detector", dest="lpips_detector_path", type=existing_path,
                   default=None,
                   help="PPL's perceptual network: the NVlabs vgg16.pt TorchScript file "
                        "(upstream's distance), or a ported LPIPS directory. Default: "
                        "checkpoints/lpips-vgg")
    p.add_argument("--ppl-sampling", choices=["end", "full"], default="end",
                   help="PPL segment sampling: 'end' (ppl2_wend, t = 0) or 'full' (t ~ U(0, 1))")
    p.add_argument("--metric", dest="metrics", action="append",
                   choices=["fid", "kid", "pr", "ppl"], default=None,
                   help="Metric(s), repeatable (default fid): fid, kid, pr (precision/recall), "
                        "ppl (perceptual path length)")
    p.set_defaults(func=fid, parser=p)
    return p


def fid(args: argparse.Namespace) -> dict:
    from viscoin_tpu_torch.cli.utils import card_or_cpu, load_generator

    metrics = tuple(args.metrics or ("fid",))
    if args.samples < 1:
        args.parser.error(f"--samples {args.samples}: need at least 1")
    device = card_or_cpu("fid", args.device)
    generator = load_generator(args.gan_path, device)
    res = generator.img_resolution
    want_features = "kid" in metrics or "pr" in metrics
    out: dict = {}

    if "fid" in metrics or want_features:
        from viscoin_tpu_torch.cli.train import DEFAULT_FID_DETECTOR, _load_fid_detector
        from viscoin_tpu_torch.data.utils import get_datasets
        from viscoin_tpu_torch.eval.fid import fid_from_stats, kid_from_stats, pr_from_stats
        from viscoin_tpu_torch.train.gan import (
            accumulate_fake_fid_stats,
            accumulate_real_fid_stats,
            make_gan_fid_fns,
        )

        detector_path = args.fid_detector_path or DEFAULT_FID_DETECTOR
        if not os.path.exists(detector_path):
            args.parser.error(f"no FID detector at {detector_path} (port one with `python -m "
                              "viscoin_tpu_torch port-weights inception` / inception-nvlabs, or "
                              "pass --fid-detector)")
        resizable = os.path.isdir(args.dataset) or args.dataset.lower().endswith(".zip")
        train_ds, _ = get_datasets(args.dataset, "gan", train_only=True,
                                   **({"out_size": res} if resizable else {}))
        if train_ds.out_size != res:
            args.parser.error(f"dataset decodes at {train_ds.out_size}² but the generator is "
                              f"{res}² — FID sides must see the same resolution")
        if len(train_ds) < args.batch_size:
            args.parser.error(f"dataset has {len(train_ds)} images < --batch-size "
                              f"{args.batch_size}: no full real-side batch can be formed "
                              "(lower --batch-size)")
        detector = _load_fid_detector(detector_path, device)
        fake_images_fn, real_images_fn = make_gan_fid_fns(args.batch_size)
        stats_real = accumulate_real_fid_stats(detector, real_images_fn, train_ds,
                                               args.batch_size, args.samples,
                                               capture_all=want_features, device=device)
        stats_fake = accumulate_fake_fid_stats(detector, fake_images_fn, generator, args.seed,
                                               args.samples, capture_all=want_features)
        if "fid" in metrics:
            out["fid"] = fid_from_stats(stats_real, stats_fake)
        if "kid" in metrics:
            out["kid"] = kid_from_stats(stats_real, stats_fake, seed=args.seed)
        if "pr" in metrics:
            out["precision"], out["recall"] = pr_from_stats(stats_real, stats_fake)
        out["real_items"] = stats_real.num_items

    if "ppl" in metrics:
        lpips_path = args.lpips_detector_path
        if lpips_path and lpips_path.endswith(".pt"):
            from viscoin_tpu_torch.eval.ppl import compute_ppl_torchscript

            print(f"PPL: the NVlabs TorchScript perceptual network ({lpips_path}, on {device})")
            out["ppl"] = compute_ppl_torchscript(generator, lpips_path, args.samples,
                                                 args.batch_size, seed=args.seed,
                                                 sampling=args.ppl_sampling)
        else:
            from viscoin_tpu_torch.cli.utils import require_lpips
            from viscoin_tpu_torch.eval.ppl import compute_ppl

            lpips = require_lpips(args.parser, "--metric ppl (PPL through a random VGG is "
                                               "meaningless):", device,
                                  **({"path": lpips_path} if lpips_path else {}))
            out["ppl"] = compute_ppl(generator, lpips, args.samples, args.batch_size,
                                     seed=args.seed, sampling=args.ppl_sampling)

    result = {**out, "samples": args.samples, "dataset": str(args.dataset),
              "gan": str(args.gan_path)}
    print(json.dumps(result))
    return result
