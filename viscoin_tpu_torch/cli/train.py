"""The ``train`` command: ``python -m viscoin_tpu_torch train viscoin ...``.

Counterpart of ``viscoin_tpu/cli/train.py`` for the ``viscoin`` model, with
its options and defaults: ``--compute-dtype`` bfloat16, ``--prefetch`` 1,
eval every 2000 iterations, checkpoints every 20 000, the faithfulness probe
every 25 000 (``--epochs`` counts iterations). Metrics go to
``viscoin_<iterations>.jsonl`` in the working directory, bundles to
``viscoin<i>-<n>/`` and the resumable training state to ``train_state/``.
The pretrained pieces come from the JAX package's checkpoint paths
(``checkpoints/<dataset>/classifier-<dataset>``, ``gan-<dataset>``,
``checkpoints/lpips-vgg``) in the npz layout; a missing one is replaced by
seeded random weights, with a warning. The ``classifier``, ``concept2clip``
and ``gan`` models are not ported yet.
"""

from __future__ import annotations

import argparse
import os

import torch

from viscoin_tpu_torch.cli.utils import add_common_options, existing_path
from viscoin_tpu_torch.data.utils import default_checkpoints, get_dataloaders
from viscoin_tpu_torch.utils.logging import configure_score_logging

NOT_PORTED = {
    "classifier": "queue 1: classifier (train/classifiers.py)",
    "concept2clip": "queue 1: Concept2CLIP (train/concept2clip.py)",
    "gan": "queue 1: GAN trainer (train/gan.py)",
}
DATA_PARALLEL = "queue 1: data parallelism (parallel/mesh.py as DDP)"
FID_DETECTOR = "queue 1: the FID detector (models/inception.py)"


def add_parser(subparsers) -> argparse.ArgumentParser:
    p = subparsers.add_parser("train", help="Train a model on a dataset; metrics are logged "
                                            "to a jsonl file.")
    p.add_argument("model_name", help="viscoin (classifier, concept2clip and gan are not "
                                      "ported yet)")
    add_common_options(p)
    p.add_argument("--gradient-accumulation-steps", type=int, default=1,
                   help="The amount of steps to accumulate gradients before stepping the "
                        "optimizers")
    p.add_argument("--data-parallel", action=argparse.BooleanOptionalAction, default=True,
                   help="Shard the batch over all visible cards (one card: runs on it; more "
                        "are not ported yet)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="Devices per model-parallel group (not ported yet beyond 1)")
    p.add_argument("--compute-dtype", choices=["bfloat16", "float32"], default="bfloat16",
                   help="Training compute precision: fp32 Adam masters and losses either way "
                        "(default: bfloat16)")
    p.add_argument("--debug-nans", action="store_true",
                   help="Fail fast on NaNs in the backward (torch anomaly detection)")
    p.add_argument("--resume", dest="resume_from", type=existing_path, default=None,
                   help="Resume viscoin training from a saved train_state directory")
    p.add_argument("--profile-dir", default=None,
                   help="Write a torch.profiler trace of training steps 2-5 into this directory")
    p.add_argument("--fid-detector", dest="fid_detector_path", type=existing_path,
                   default=None, help="FID feature detector (not ported yet)")
    p.add_argument("--image-size", type=int, default=None,
                   help="[image-folder datasets] Square resolution images are trained at")
    p.add_argument("--eval-every", type=int, default=None,
                   help="Full test-set eval cadence in iterations (default 2000); 0 disables")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="Checkpoint cadence in iterations (default 20000); 0 disables")
    p.add_argument("--faithfulness-every", type=int, default=None,
                   help="200-image faithfulness probe cadence (default 25000); 0 disables")
    p.add_argument("--prefetch", type=int, default=None,
                   help="Batches loaded and placed on the device ahead of the running step "
                        "(background thread, order-preserving); 0 = synchronous (default 1)")
    p.set_defaults(func=train)
    return p


def train(args: argparse.Namespace) -> None:
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    if args.model_name in NOT_PORTED:
        raise NotImplementedError(f"`train {args.model_name}` is not ported yet "
                                  f"(ROADMAP.md, {NOT_PORTED[args.model_name]})")
    if args.model_name != "viscoin":
        raise ValueError(f"Unknown model name: {args.model_name}")
    cadences = {k: getattr(args, k) for k in ("eval_every", "checkpoint_every",
                                              "faithfulness_every")
                if getattr(args, k) is not None}
    _train_viscoin(args.dataset, args.learning_rate, args.epochs, args.batch_size,
                   args.gradient_accumulation_steps, args.data_parallel, args.resume_from,
                   args.profile_dir, args.fid_detector_path, model_parallel=args.model_parallel,
                   compute_dtype=args.compute_dtype,
                   ds_kwargs=_dataset_kwargs(args.dataset, args.image_size),
                   prefetch=1 if args.prefetch is None else args.prefetch, device=args.device,
                   **cadences)


def _dataset_kwargs(dataset: str, image_size) -> dict:
    """--image-size sets an image-folder dataset's resolution; the registry
    datasets' geometries are fixed."""
    if image_size is None:
        return {}
    if not (os.path.isdir(dataset) or dataset.lower().endswith(".zip")):
        raise ValueError("--image-size applies to image-folder (path) datasets; "
                         f"{dataset!r} is a registry dataset with a fixed geometry")
    return {"out_size": image_size}


def _check_parallelism(device: torch.device, data_parallel: bool, model_parallel: int) -> None:
    """One card (or the CPU) is all the port trains on."""
    if model_parallel > 1:
        raise NotImplementedError(f"--model-parallel {model_parallel} is not ported yet "
                                  f"(ROADMAP.md, {DATA_PARALLEL})")
    visible = torch.cuda.device_count() if device.type == "cuda" else 1
    if data_parallel and visible > 1:
        raise NotImplementedError(
            f"--data-parallel over {visible} visible cards is not ported yet (ROADMAP.md, "
            f"{DATA_PARALLEL}); make one card visible (CUDA_VISIBLE_DEVICES) or pass "
            "--no-data-parallel")


def build_viscoin_modules(n_classes: int, size: int, device="cuda"):
    """The ``train viscoin`` ensemble (the JAX package's flagship: ResNet-50,
    256 concepts, ``GeneratorAdapted`` with channel_base 16384), the frozen
    original ``Generator`` (z 512, w 512, 2 mapping layers) and LPIPS-VGG, on
    ``device``, with random weights from seeds 0, 1 and 2.

    Returns ``(models, generator, lpips)``."""
    from viscoin_tpu_torch.models.bundle import default_models, init_models
    from viscoin_tpu_torch.models.lpips import LPIPS
    from viscoin_tpu_torch.models.stylegan import Generator

    models = default_models(n_classes=n_classes, img_resolution=size, channel_base=16384,
                            device=device, seed=0)
    generator = init_models(Generator(z_dim=512, w_dim=512, img_resolution=size,
                                      channel_base=16384, mapping_layers=2, device=device), 1)
    lpips = init_models(LPIPS(device=device), 2)
    return models, generator, lpips


def _train_viscoin(dataset: str, learning_rate, epochs, batch_size, gradient_accumulation_steps,
                   data_parallel, resume_from=None, profile_dir=None, fid_detector_path=None,
                   model_parallel=1, compute_dtype="bfloat16", ds_kwargs=None, eval_every=2000,
                   checkpoint_every=20_000, faithfulness_every=25_000, prefetch=1,
                   device="cuda"):
    from viscoin_tpu_torch.models.stylegan import adapted_state_from_gan
    from viscoin_tpu_torch.train.viscoin import VisCoINTrainingParams, train_viscoin
    from viscoin_tpu_torch.utils import checkpoints as ckpt
    from viscoin_tpu_torch.utils.weights import load_jax_tree

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train viscoin --device cuda: no CUDA device is available; pass "
                           "--device cpu to train with the plain versions on the CPU")
    _check_parallelism(device, data_parallel, model_parallel)
    if fid_detector_path is not None:
        raise NotImplementedError(f"--fid-detector: the Inception detector is not ported yet "
                                  f"(ROADMAP.md, {FID_DETECTOR})")

    # Unset options fall back to the dataclass defaults, as the JAX command's do.
    params = VisCoINTrainingParams(**{k: v for k, v in dict(
        learning_rate=learning_rate, iterations=epochs, batch_size=batch_size,
        gradient_accumulation=gradient_accumulation_steps,
        compute_dtype=compute_dtype).items() if v is not None})
    configure_score_logging(f"viscoin_{params.iterations}.jsonl")
    train_loader, test_loader = get_dataloaders(dataset, params.batch_size, **(ds_kwargs or {}))
    n_classes = train_loader.dataset.N_CLASSES
    size = train_loader.dataset.out_size
    models, generator, lpips = build_viscoin_modules(n_classes, size, device)

    paths = default_checkpoints(dataset)
    if os.path.exists(paths["classifier"]):
        load_jax_tree(models.classifier, ckpt.restore_pytree(paths["classifier"]))
    else:
        print(f"WARNING: classifier checkpoint {paths['classifier']} not found — training "
              "against a RANDOM classifier.")
    if os.path.exists(paths["gan"]):
        load_jax_tree(generator, ckpt.restore_pytree(paths["gan"]))
        models.gan.load_state_dict(adapted_state_from_gan(models.gan.state_dict(),
                                                          generator.state_dict()))
    else:
        print(f"WARNING: GAN checkpoint {paths['gan']} not found — using a RANDOM generator.")
    lpips_path = "checkpoints/lpips-vgg"
    if os.path.exists(lpips_path):
        load_jax_tree(lpips, {"params": ckpt.restore_pytree(lpips_path)})
    else:
        print("WARNING: no LPIPS weights at checkpoints/lpips-vgg — random-VGG perceptual loss.")
    if os.path.exists("checkpoints/inception"):
        print(f"NOTE: checkpoints/inception is not used: the FID detector is not ported yet "
              f"(ROADMAP.md, {FID_DETECTOR}); in-training eval skips FID.")
    else:
        print("NOTE: no checkpoints/inception — in-training eval skips FID.")

    train_viscoin(models, generator, lpips, train_loader, test_loader, params,
                  resume_from=resume_from, profile_dir=profile_dir, eval_every=eval_every,
                  checkpoint_every=checkpoint_every, faithfulness_every=faithfulness_every,
                  prefetch=prefetch, device=device)
