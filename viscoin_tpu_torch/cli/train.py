"""The ``train`` command: ``python -m viscoin_tpu_torch train
classifier|viscoin|gan|concept2clip ...``.

Counterpart of ``viscoin_tpu/cli/train.py``, with its options and defaults.

``classifier``: the ResNet-50 classifier (random weights from seed 0, or
``--checkpoints``) for ``--epochs`` epochs (default 90), Adam (or
``--optimizer sgd`` with ``--momentum``) at ``--learning-rate`` (default
1e-3) x0.1 after 30 and 60 epochs, ``--compute-dtype`` bfloat16, a test pass
per epoch. Metrics go to ``classifier_<epochs>.jsonl``; the best test
accuracy's variables to ``--output-weights`` in the npz layout that ``train
viscoin`` reads at ``checkpoints/<dataset>/classifier-<dataset>`` and
``test classifier --checkpoints`` reads.

``viscoin``: ``--compute-dtype`` bfloat16, ``--prefetch`` 1, eval every 2000
iterations, checkpoints every 20 000, the faithfulness probe every 25 000.
Metrics go to ``viscoin_<iterations>.jsonl`` in the working directory,
bundles to ``viscoin<i>-<n>/`` and the resumable training state to
``train_state/``. The pretrained pieces come from the JAX package's
checkpoint paths (``checkpoints/<dataset>/classifier-<dataset>``,
``gan-<dataset>``, ``checkpoints/lpips-vgg``) in the npz layout, as
``port-weights`` writes them; a missing one is replaced by seeded random
weights, with a warning. The FID detector of the eval is ``--fid-detector``
or ``checkpoints/inception`` when present (``_load_fid_detector``).

``gan``: StyleGAN2 (z 512, w 512, 2 mapping layers, ``--channel-base``
16384, ``--channel-max`` 512, the mbstd group min(4, batch)) trained on the
dataset's ``gan`` transform, batch 16, ``--compute-dtype`` bfloat16,
``--prefetch`` 0, checkpoints every 10 000 to ``<output-weights>.train_state``.
Metrics go to ``gan_<iterations>.jsonl``; at the end the EMA generator, with
its tracked w_avg, is written to ``--output-weights`` in the npz layout that
``train viscoin`` reads at ``checkpoints/<dataset>/gan-<dataset>``.
``--cfg paper1024`` takes stylegan2-ada-pytorch's published 1024² setting
instead (``train/gan.py::GAN_PRESETS``): 8 mapping layers, channel base 32768,
float16 in the blocks of the four top resolutions with float32 masters and
losses, every activation clamped to ±256, global batch 32, lr 0.002, R1
gamma 2, the path length on half the batch; ``--batch-size`` and
``--learning-rate`` override its batch and lr where given, ``--channel-base``
and ``--channel-max`` do not apply, and ``--model-parallel`` or an explicit
``--compute-dtype bfloat16`` is refused. Its export records ``num_fp16_res``
and ``conv_clamp`` beside the weights (the tree's "config").
``--fid-every N`` adds the upstream trainer's snapshot metric: every N
iterations and at the last, the FID of ``--fid-samples`` (default 8192)
EMA-generator samples against as many training images, logged to the jsonl
as ``{"iteration", "fid"}``; the detector is ``--fid-detector`` or
``checkpoints/inception``.

``--data-parallel`` (the default) trains over every visible card, as the
JAX command does over every device, one process per card
(``parallel/mesh.py``): under ``torchrun`` the command joins its group
(``torchrun --nproc-per-node N -m viscoin_tpu_torch train ...``, any N,
even 1); otherwise, with several visible cards, it starts one worker
process per card itself. ``--batch-size`` stays the global batch. With one
card (or the CPU) and no ``torchrun``, there is no mesh. Rank 0 writes the
logs and the checkpoints. ``train viscoin|gan --model-parallel M`` arranges
the processes as a 2-D ``(data, model)`` mesh (``parallel/spatial.py``): each
group of M consecutive ranks splits its data shard's images along H, so there
must be a multiple of M of them (``torchrun --nproc-per-node D*M``, or D*M
visible cards, one spawned worker each), and the images must shard (a
geometry that cannot is refused before training). ``classifier`` and
``concept2clip`` ignore it, as the JAX command does.

``concept2clip``: the MLP from the bundle at
``checkpoints/<dataset>/viscoin-<dataset>``'s concept space (``--latent-type
viscoin``, the default) or W+ space (``gan``) to CLIP ViT-B/32's image
embeddings, over both splits of the dataset at the test geometry: 30 epochs
(``--epochs``), Adam at 1e-5, batch 32, seeded from 0. The spaces and the
embeddings are cached under ``checkpoints/`` in the JAX package's files
(``eval/spaces.py``, ``models/clip.py``); CLIP's weights come from
``checkpoints/clip/vit-b-32`` (``port-weights clip``), else from a seed, with
a warning. Metrics go to ``concept2clip_<epochs>.jsonl``; the best test
loss's parameters to ``--output-weights`` in the npz layout. It runs in one
process on one device, as the JAX command runs in one process: no worker is
spawned, and a ``torchrun`` group of several processes is refused.
"""

from __future__ import annotations

import argparse
import os

import torch

from viscoin_tpu_torch.cli.utils import add_common_options, card_or_cpu, existing_path
from viscoin_tpu_torch.data.utils import default_checkpoints, get_dataloaders
from viscoin_tpu_torch.parallel.mesh import destroy_mesh
from viscoin_tpu_torch.utils.logging import configure_score_logging

DEFAULT_FID_DETECTOR = "checkpoints/inception"
GAN_CFGS = ("paper1024",)  # train/gan.py::GAN_PRESETS


class _Given(argparse._StoreAction):
    """A store action that also records its option's name in ``given`` (an
    option given as its default is told apart from one left out)."""

    def __call__(self, parser, namespace, values, option_string=None):
        super().__call__(parser, namespace, values, option_string)
        namespace.given = set(getattr(namespace, "given", ())) | {self.dest}


def add_parser(subparsers) -> argparse.ArgumentParser:
    p = subparsers.add_parser("train", help="Train a model on a dataset; metrics are logged "
                                            "to a jsonl file.")
    p.add_argument("model_name", help="classifier, viscoin, gan or concept2clip")
    add_common_options(p)
    p.add_argument("--gradient-accumulation-steps", type=int, default=1,
                   help="The amount of steps to accumulate gradients before stepping the "
                        "optimizers")
    p.add_argument("--latent-type", choices=["viscoin", "gan"], default="viscoin",
                   help="The latent space to train concept2clip on")
    p.add_argument("--data-parallel", action=argparse.BooleanOptionalAction, default=True,
                   help="Shard the batch over all visible cards, one process per card (under "
                        "torchrun: over its processes)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="[viscoin/gan] Devices per model-parallel group: a 2-D (data, model) mesh "
                        "whose 'model' axis splits the images' H axis through the train step "
                        "(explicit halo exchanges), for scaling past the per-card batch "
                        "minimum")
    p.add_argument("--optimizer", choices=["adam", "sgd"], default=None,
                   help="[classifier] Optimizer (default adam; sgd for the reference README's "
                        "SGD recipe)")
    p.add_argument("--momentum", type=float, default=None,
                   help="[classifier] SGD momentum (default 0.9)")
    p.add_argument("--compute-dtype", choices=["bfloat16", "float32"], default="bfloat16",
                   action=_Given,
                   help="Training compute precision: fp32 Adam masters and losses either way "
                        "(default: bfloat16)")
    p.add_argument("--debug-nans", action="store_true",
                   help="Fail fast on NaNs in the backward (torch anomaly detection)")
    p.add_argument("--resume", dest="resume_from", type=existing_path, default=None,
                   help="Resume viscoin training from a saved train_state directory")
    p.add_argument("--profile-dir", default=None,
                   help="Write a torch.profiler trace of training steps 2-5 into this directory")
    p.add_argument("--fid-detector", dest="fid_detector_path", type=existing_path,
                   default=None,
                   help="[viscoin/gan] FID feature detector: a ported directory (pytorch-fid or "
                        "inception-nvlabs convention, told apart by its fid_convention.json) or "
                        "the NVlabs TorchScript inception-2015-12-05.pt itself. Default: "
                        "checkpoints/inception if present")
    p.add_argument("--image-size", type=int, default=None,
                   help="[image-folder datasets] Square resolution images are trained at")
    p.add_argument("--eval-every", type=int, default=None,
                   help="Full test-set eval cadence in iterations (default 2000); 0 disables")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="Checkpoint cadence in iterations (default 20000 for viscoin, 10000 "
                        "for gan); 0 disables")
    p.add_argument("--faithfulness-every", type=int, default=None,
                   help="200-image faithfulness probe cadence (default 25000); 0 disables")
    p.add_argument("--prefetch", type=int, default=None,
                   help="Batches loaded and placed on the device ahead of the running step "
                        "(background thread, order-preserving); 0 = synchronous (default 1 "
                        "for viscoin, 0 for gan)")
    p.add_argument("--channel-base", type=int, default=16384,
                   help="[gan] StyleGAN2 channel base (16384 is the reference 256² config)")
    p.add_argument("--channel-max", type=int, default=512,
                   help="[gan] StyleGAN2 channel cap per layer")
    p.add_argument("--fid-every", type=int, default=0,
                   help="[gan] FID of EMA-generator samples against the training images every "
                        "N iterations (needs a FID detector, see --fid-detector); 0 disables")
    p.add_argument("--fid-samples", type=int, default=8192,
                   help="[gan] Samples per side of each in-loop FID estimate")
    p.add_argument("--init-from", default=None, type=existing_path,
                   help="[gan] Warm start: generator variables in the npz layout (a `train "
                        "gan` export; + <path>.discriminator if present) into a fresh run")
    p.add_argument("--ema-rampup", type=float, default=None,
                   help="[gan] EMA half-life warm-up cap as a fraction of images seen "
                        "(default 0 = off)")
    p.add_argument("--mirror", action=argparse.BooleanOptionalAction, default=True,
                   help="[gan] Dataset x-flip doubling (default on)")
    p.add_argument("--cfg", choices=["auto", *GAN_CFGS], default="auto",
                   help="[gan] auto: the options above; paper1024: stylegan2-ada-pytorch's "
                        "1024² setting (fp16 in the four top resolutions, conv clamp 256, "
                        "8 mapping layers, batch 32)")
    p.add_argument("--snapshot-every", type=int, default=0,
                   help="[gan] Write a fakes_<it>.png grid of 16 EMA-generator samples every "
                        "N iterations, from fixed latents; 0 disables")
    p.set_defaults(func=train, parser=p)
    return p


def train(args: argparse.Namespace) -> None:
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    if args.model_name not in ("classifier", "gan", "viscoin", "concept2clip"):
        raise ValueError(f"Unknown model name: {args.model_name}")
    ds_kwargs = _dataset_kwargs(args.dataset, args.image_size)
    if args.model_name == "concept2clip":
        from viscoin_tpu_torch.eval.concept2clip import check_one_process

        check_one_process(int(os.environ.get("WORLD_SIZE", "1")))
        _train_concept2clip(args.latent_type, args.dataset, args.epochs, args.learning_rate,
                            args.batch_size, args.output_weights, ds_kwargs=ds_kwargs,
                            device=args.device)
        return
    if args.model_name == "gan":
        detector = args.fid_detector_path or DEFAULT_FID_DETECTOR
        if args.fid_every and not os.path.exists(detector):
            args.parser.error(f"--fid-every needs a FID detector; none at {detector} (port one "
                              "with `python -m viscoin_tpu_torch port-weights inception`, or "
                              "pass --fid-detector)")
        if args.cfg != "auto" and args.model_parallel > 1:
            args.parser.error(f"--cfg {args.cfg} runs float16 blocks, which do not run on a "
                              "model axis: drop --model-parallel")
        if args.cfg != "auto" and "compute_dtype" in getattr(args, "given", ()) \
                and args.compute_dtype != "float32":
            args.parser.error(f"--cfg {args.cfg} sets its own precision (float16 blocks in "
                              "float32 networks); --compute-dtype bfloat16 cannot combine "
                              "with it")
    model_parallel = args.model_parallel if args.model_name in ("viscoin", "gan") else 1
    device = card_or_cpu(f"train {args.model_name}", args.device)
    workers = _spawned_workers(device, args.data_parallel, model_parallel)
    if workers > 1:
        _spawn(args, workers)
        return
    mesh = _build_mesh(device, args.data_parallel, model_parallel)
    try:
        _train(args, ds_kwargs, mesh, device if mesh is None else mesh.device)
    finally:
        destroy_mesh(mesh)


def _train(args: argparse.Namespace, ds_kwargs: dict, mesh, device) -> None:
    if args.model_name == "classifier":
        _train_classifier(args.dataset, args.checkpoints, args.batch_size, args.learning_rate,
                          args.epochs, args.output_weights, compute_dtype=args.compute_dtype,
                          optimizer=args.optimizer, momentum=args.momentum, ds_kwargs=ds_kwargs,
                          device=device, mesh=mesh)
    elif args.model_name == "gan":
        _train_gan(args.dataset, args.learning_rate, args.epochs, args.batch_size,
                   args.output_weights, args.channel_base, args.channel_max,
                   resume_from=args.resume_from, compute_dtype=args.compute_dtype,
                   fid_detector_path=args.fid_detector_path, fid_every=args.fid_every,
                   fid_samples=args.fid_samples, mirror=args.mirror,
                   snapshot_every=args.snapshot_every, init_from=args.init_from,
                   ema_rampup=args.ema_rampup, cfg=args.cfg,
                   prefetch=0 if args.prefetch is None else args.prefetch,
                   ds_kwargs=ds_kwargs, device=device, mesh=mesh,
                   **({"checkpoint_every": args.checkpoint_every}
                      if args.checkpoint_every is not None else {}))
    else:
        cadences = {k: getattr(args, k) for k in ("eval_every", "checkpoint_every",
                                                  "faithfulness_every")
                    if getattr(args, k) is not None}
        _train_viscoin(args.dataset, args.learning_rate, args.epochs, args.batch_size,
                       args.gradient_accumulation_steps, args.resume_from, args.profile_dir,
                       args.fid_detector_path, compute_dtype=args.compute_dtype,
                       ds_kwargs=ds_kwargs,
                       prefetch=1 if args.prefetch is None else args.prefetch, device=device,
                       mesh=mesh, **cadences)


def _dataset_kwargs(dataset: str, image_size) -> dict:
    """--image-size sets an image-folder dataset's resolution; the registry
    datasets' geometries are fixed."""
    if image_size is None:
        return {}
    if not (os.path.isdir(dataset) or dataset.lower().endswith(".zip")):
        raise ValueError("--image-size applies to image-folder (path) datasets; "
                         f"{dataset!r} is a registry dataset with a fixed geometry")
    return {"out_size": image_size}


def _spawned_workers(device: torch.device, data_parallel: bool, model_parallel: int) -> int:
    """How many worker processes the command starts itself: one per visible
    card with --data-parallel over several cards outside torchrun, else 0
    (this process trains). Refuses a --model-parallel that the JAX command
    refuses, in its words: without --data-parallel, or one that does not
    divide the processes (torchrun's) or the visible cards."""
    visible = torch.cuda.device_count() if device.type == "cuda" else 1
    if model_parallel > 1:
        if not data_parallel:
            raise ValueError("--model-parallel requires --data-parallel (the mesh is 2-D "
                             "(data, model))")
        n = int(os.environ.get("WORLD_SIZE", visible))
        if n % model_parallel:
            raise ValueError(f"--model-parallel={model_parallel} does not divide the {n} "
                             "available devices")
    if data_parallel and visible > 1 and "WORLD_SIZE" not in os.environ:
        return visible
    return 0


def _build_mesh(device: torch.device, data_parallel: bool, model_parallel: int = 1):
    """The mesh of this process: the torchrun group it was started in
    (``WORLD_SIZE`` set, whatever the size), 1-D, or 2-D with
    ``model_parallel`` > 1; else None."""
    from viscoin_tpu_torch.parallel.mesh import is_main, make_mesh, make_mesh_2d

    if "WORLD_SIZE" not in os.environ:
        return None
    if not data_parallel:
        raise ValueError(f"--no-data-parallel in a group of {os.environ['WORLD_SIZE']} "
                         "processes (WORLD_SIZE is set): run one process, or drop the flag")
    if model_parallel > 1:
        data = int(os.environ["WORLD_SIZE"]) // model_parallel
        mesh = make_mesh_2d(data, model_parallel, device)
        if is_main(mesh):
            print(f"mesh: ({data} data, {model_parallel} model) — images' H axis spatially "
                  "sharded over 'model'", flush=True)
        return mesh
    return make_mesh(device)


def _spawn(args: argparse.Namespace, n: int) -> None:
    """Run the command in ``n`` worker processes, one per visible card,
    joined over 127.0.0.1 at a free port; returns when all have finished
    and raises if one failed."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    options = {k: v for k, v in vars(args).items() if k not in ("func", "parser")}
    print(f"--data-parallel: {n} visible cards, one worker process each (127.0.0.1:{port})",
          flush=True)
    mp.start_processes(_worker, args=(n, port, options), nprocs=n, join=True,
                       start_method="spawn")


def _worker(rank: int, world: int, port: int, options: dict) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    train(argparse.Namespace(**options, parser=None))


def _train_classifier(dataset: str, checkpoints, batch_size, learning_rate, epochs,
                      output_weights, compute_dtype="bfloat16", optimizer=None, momentum=None,
                      ds_kwargs=None, device="cuda", mesh=None):
    """The classifier stage: train, then save the best test accuracy's
    variables to ``output_weights`` (npz layout)."""
    from viscoin_tpu_torch.parallel.mesh import is_main
    from viscoin_tpu_torch.train.classifiers import ClassifierTrainingParams, train_classifier
    from viscoin_tpu_torch.utils import checkpoints as ckpt
    from viscoin_tpu_torch.utils.weights import load_jax_tree

    device = card_or_cpu("train classifier", device)
    params = ClassifierTrainingParams(epochs, learning_rate, batch_size,
                                      compute_dtype=compute_dtype, optimizer=optimizer,
                                      momentum=momentum)
    if is_main(mesh):
        configure_score_logging(f"classifier_{params.epochs}.jsonl")
    train_loader, test_loader = get_dataloaders(dataset, params.batch_size, **_sharded(
        ds_kwargs, mesh))
    model = build_classifier(train_loader.dataset.N_CLASSES, device)
    if checkpoints is not None:
        load_jax_tree(model, ckpt.restore_pytree(checkpoints))
    elif is_main(mesh):
        print("NOTE: no --checkpoints given: random init (port pretrained torch weights with "
              "`python -m viscoin_tpu_torch port-weights classifier`).")
    best, _ = train_classifier(model, train_loader, test_loader, params, mesh=mesh)
    if is_main(mesh):
        ckpt.save_pytree(best, output_weights)
    ckpt.wait_for_saves(mesh)


def _sharded(ds_kwargs: dict | None, mesh) -> dict:
    """``get_dataloaders`` options: with a mesh, this rank's shard of every
    global batch, the test loader's ragged tail padded (and masked)."""
    if mesh is None:
        return dict(ds_kwargs or {})
    data = mesh.data_axis
    return {**(ds_kwargs or {}), "shard": (data.rank, data.world)}


def build_classifier(n_classes: int, device="cuda"):
    """The ResNet-50 classifier of the JAX command, random from seed 0."""
    from viscoin_tpu_torch.models.bundle import init_models
    from viscoin_tpu_torch.models.resnet import Classifier

    return init_models(Classifier(output_classes=n_classes, device=device), 0)


def _load_fid_detector(path: str, device):
    """The FID detector at ``path``: the NVlabs TorchScript file (``.pt``,
    run as it is), a ported NVlabs-convention directory (its
    ``fid_convention.json`` says so), or a pytorch-fid-convention one."""
    import json

    from viscoin_tpu_torch.models import inception
    from viscoin_tpu_torch.utils import checkpoints as ckpt

    if path.endswith(".pt"):
        print(f"FID: the NVlabs TorchScript detector itself ({path}, on {device})")
        return inception.make_torchscript_fid_detector(path, device)
    marker = os.path.join(path, "fid_convention.json")
    if os.path.exists(marker):
        with open(marker) as f:
            if json.load(f).get("convention") == "nvlabs":
                print(f"FID: ported NVlabs-convention detector ({path})")
                return inception.make_nvlabs_fid_detector(ckpt.restore_pytree(path), device)
    print(f"FID: ported pytorch-fid-convention detector ({path})")
    return inception.make_fid_detector(ckpt.restore_pytree(path), device)


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
                   resume_from=None, profile_dir=None, fid_detector_path=None,
                   compute_dtype="bfloat16", ds_kwargs=None, eval_every=2000,
                   checkpoint_every=20_000, faithfulness_every=25_000, prefetch=1,
                   device="cuda", mesh=None):
    from viscoin_tpu_torch.models.stylegan import adapted_state_from_gan
    from viscoin_tpu_torch.parallel.mesh import is_main
    from viscoin_tpu_torch.train.viscoin import VisCoINTrainingParams, train_viscoin
    from viscoin_tpu_torch.utils import checkpoints as ckpt
    from viscoin_tpu_torch.utils.weights import load_jax_tree

    device = card_or_cpu("train viscoin", device)

    # Unset options fall back to the dataclass defaults, as the JAX command's do.
    params = VisCoINTrainingParams(**{k: v for k, v in dict(
        learning_rate=learning_rate, iterations=epochs, batch_size=batch_size,
        gradient_accumulation=gradient_accumulation_steps,
        compute_dtype=compute_dtype).items() if v is not None})
    if mesh is not None:
        mesh.local(params.batch_size)  # the global batch must divide over the ranks
    if is_main(mesh):
        configure_score_logging(f"viscoin_{params.iterations}.jsonl")
    train_loader, test_loader = get_dataloaders(dataset, params.batch_size,
                                                **_sharded(ds_kwargs, mesh))
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
    fid_detector = None
    detector_path = fid_detector_path or DEFAULT_FID_DETECTOR
    if os.path.exists(detector_path):
        fid_detector = _load_fid_detector(detector_path, device)
    else:
        print(f"NOTE: no {DEFAULT_FID_DETECTOR}: in-training eval skips FID (port weights with "
              "`python -m viscoin_tpu_torch port-weights inception`, or pass --fid-detector).")

    train_viscoin(models, generator, lpips, train_loader, test_loader, params, mesh=mesh,
                  resume_from=resume_from, profile_dir=profile_dir, fid_detector=fid_detector,
                  eval_every=eval_every,
                  checkpoint_every=checkpoint_every, faithfulness_every=faithfulness_every,
                  prefetch=prefetch, device=device)


def _train_concept2clip(latent_type: str, dataset: str, epochs, learning_rate, batch_size,
                        output_weights: str, ds_kwargs=None, device="cuda"):
    """The MLP from the bundle's concept (``latent_type`` "viscoin") or W+
    ("gan") space to CLIP's image embeddings; the best parameters to
    ``output_weights`` (npz layout)."""
    from viscoin_tpu_torch.data.utils import get_datasets
    from viscoin_tpu_torch.eval.spaces import compute_concept_space, compute_w_space
    from viscoin_tpu_torch.models.bundle import init_models
    from viscoin_tpu_torch.models.clip import CLIP, compute_image_embeddings
    from viscoin_tpu_torch.models.concept2clip import Concept2CLIP, Concept2CLIPStyleGAN
    from viscoin_tpu_torch.train.concept2clip import (
        Concept2ClipTrainingParams,
        train_concept2clip,
    )
    from viscoin_tpu_torch.utils import checkpoints as ckpt

    device = card_or_cpu("train concept2clip", device)
    viscoin = ckpt.load_viscoin_bundle(default_checkpoints(dataset)["viscoin"], device=device)
    params = Concept2ClipTrainingParams(epochs=epochs, learning_rate=learning_rate,
                                        batch_size=batch_size)
    configure_score_logging(f"concept2clip_{params.epochs}.jsonl")
    train_ds, test_ds = get_datasets(dataset, "test", **(ds_kwargs or {}))
    if latent_type == "viscoin":
        train_spaces, test_spaces = compute_concept_space(viscoin, dataset, train_ds, test_ds)
        model = Concept2CLIP(n_concepts=viscoin.concept_extractor.config["n_concepts"],
                             device=device)
    else:
        train_spaces, test_spaces = compute_w_space(viscoin, dataset, train_ds, test_ds)
        model = Concept2CLIPStyleGAN(n_style_layers=viscoin.gan.num_ws,
                                     layer_dim=viscoin.gan.config["w_dim"], device=device)
    del viscoin
    train_emb, test_emb = compute_image_embeddings(CLIP(device=device), dataset, train_ds,
                                                   test_ds)
    best, _ = train_concept2clip(init_models(model, 0), train_spaces, train_emb, test_spaces,
                                 test_emb, params)
    ckpt.save_pytree(best, output_weights)


def build_gan_modules(size: int, channel_base: int, channel_max: int, batch_size: int,
                      device="cuda", seed: int = 0, *, mapping_layers: int = 2,
                      num_fp16_res: int = 0, conv_clamp: float | None = None):
    """The ``train gan`` generator and discriminator, as the JAX command
    builds them: z 512, w 512, 2 mapping layers, the given channels, the
    mbstd group min(4, batch); random weights from ``seed`` (G) and
    ``seed + 1`` (D), on ``device``. A preset (``--cfg``) also sets the
    mapping depth, the float16 blocks and the clamp of both networks."""
    from viscoin_tpu_torch.models.bundle import init_models
    from viscoin_tpu_torch.models.stylegan import Discriminator, Generator

    generator = Generator(z_dim=512, w_dim=512, img_resolution=size, channel_base=channel_base,
                          channel_max=channel_max, mapping_layers=mapping_layers,
                          conv_clamp=conv_clamp, num_fp16_res=num_fp16_res, device=device)
    discriminator = Discriminator(img_resolution=size, channel_base=channel_base,
                                  channel_max=channel_max,
                                  mbstd_group_size=min(4, batch_size), conv_clamp=conv_clamp,
                                  num_fp16_res=num_fp16_res, device=device)
    return init_models(generator, seed), init_models(discriminator, seed + 1)


# The fixed tags of the FID draws and of the snapshot grid's seed, apart from
# the step seeds (and from --epochs, so a resume keeps them).
_FID_TAG, _SNAPSHOT_TAG = 0x7FFFFFFE, 0x7FFFFFFF


def _train_gan(dataset: str, learning_rate, epochs, batch_size, output_weights,
               channel_base=16384, channel_max=512, resume_from=None, checkpoint_every=10_000,
               seed=0, compute_dtype="bfloat16", fid_detector_path=None,
               fid_every=0, fid_samples=8192, mirror=True, snapshot_every=0, init_from=None,
               ema_rampup=None, cfg="auto", ds_kwargs=None, prefetch=0, device="cuda",
               mesh=None):
    """StyleGAN2 training (``epochs`` counts iterations): the metrics every
    100 iterations and the last to ``gan_<iterations>.jsonl``, the training
    state every ``checkpoint_every`` iterations (i > start) and at the end to
    ``<output_weights>.train_state``, and at the end the EMA generator to
    ``output_weights``. ``resume_from`` continues a run exactly (the loader
    fast-forwards, step draws come from (seed, step)); ``init_from`` warm
    starts a fresh one. ``fid_every``: the FID of ``fid_samples`` EMA samples
    (batch j of the estimate at iteration i seeded ``fold_seed(fold_seed(seed,
    FID_TAG, i), j)``) against the first ``fid_samples`` training images in
    order, every ``fid_every`` iterations (i > start) and at the last. With
    a data-parallel ``mesh`` each rank loads and steps on its shard of every
    global batch and samples its share of the FID fakes; on a 2-D one each
    data shard's ranks load its shard and each keeps its H rows of the
    images; rank 0 logs and writes. ``cfg`` a preset of ``GAN_PRESETS``
    ("auto": the arguments alone)."""
    import json

    import numpy as np

    from viscoin_tpu_torch.data.loader import DataLoader, DevicePrefetcher, loop_iter
    from viscoin_tpu_torch.data.utils import get_datasets
    from viscoin_tpu_torch.eval.viscoin import to_device
    from viscoin_tpu_torch.parallel.mesh import broadcast_tree, is_main
    from viscoin_tpu_torch.parallel.spatial import gan_spatial
    from viscoin_tpu_torch.train.gan import (
        GAN_PRESETS,
        GANTrainingParams,
        create_gan_train_state,
        draw_step,
        export_generator_vars,
        make_gan_snapshot_fn,
        make_gan_train_step,
        warm_start_gan_state,
    )
    from viscoin_tpu_torch.train.viscoin import fold_seed
    from viscoin_tpu_torch.utils import checkpoints as ckpt
    from viscoin_tpu_torch.utils.logging import get_logger

    device = card_or_cpu("train gan", device)
    detector_path = fid_detector_path or DEFAULT_FID_DETECTOR
    if fid_every and not os.path.exists(detector_path):
        raise ValueError(f"--fid-every needs a FID detector; none at {detector_path} (port one "
                         "with `python -m viscoin_tpu_torch port-weights inception`, or pass "
                         "--fid-detector)")
    if init_from and resume_from:
        raise ValueError("--init-from is a fresh warm start (weights only); --resume "
                         "continues a run exactly: pick one")
    preset = None if cfg == "auto" else GAN_PRESETS[cfg]
    cfg_name = cfg
    cfg = GANTrainingParams(**{**(preset["training"] if preset else {}), **{
        k: v for k, v in dict(
            iterations=epochs, learning_rate=learning_rate, batch_size=batch_size,
            compute_dtype=None if preset else compute_dtype, mirror=mirror,
            ema_rampup=ema_rampup).items() if v is not None}})
    # The JAX command's multi-process rules: a batch that divides over the
    # data axis, one loader shard per data shard (the same global order
    # everywhere); on a 2-D mesh, images whose H axis shards.
    shard = (0, 1) if mesh is None else (mesh.data_axis.rank, mesh.data_axis.world)
    local_bs = cfg.batch_size if mesh is None else mesh.local(cfg.batch_size)
    train_ds, _ = get_datasets(dataset, "gan", train_only=True, **(ds_kwargs or {}))
    loader = DataLoader(train_ds, cfg.batch_size, shuffle=True, shard=shard)
    if len(train_ds) < cfg.batch_size:
        raise ValueError(f"dataset has {len(train_ds)} samples < batch_size={cfg.batch_size}: "
                         "no full batch can ever be formed")
    size = train_ds.out_size
    sp = gan_spatial(mesh, size)
    rows = slice(None) if sp is None else sp.rows(size)
    if preset is None:
        generator, discriminator = build_gan_modules(size, channel_base, channel_max,
                                                     cfg.batch_size, device, seed)
    else:
        m = preset["model"]
        generator, discriminator = build_gan_modules(
            size, m["channel_base"], m["channel_max"], cfg.batch_size, device, seed,
            mapping_layers=m["mapping_layers"], num_fp16_res=m["num_fp16_res"],
            conv_clamp=m["conv_clamp"])
    if is_main(mesh):
        configure_score_logging(f"gan_{cfg.iterations}.jsonl")
    logger = get_logger()
    state = create_gan_train_state(generator, discriminator, cfg)
    if init_from:
        d_path = f"{init_from}.discriminator"
        d_params = ckpt.restore_pytree(d_path) if os.path.exists(d_path) else None
        warm_start_gan_state(state, ckpt.restore_pytree(init_from), d_params)
        print(f"warm start from {init_from} (generator"
              + (" + discriminator)" if d_params is not None else "; fresh discriminator)"))
    step = make_gan_train_step(generator, discriminator, cfg, mesh)
    snapshot_fn = make_gan_snapshot_fn(16) if snapshot_every else None
    fid = None
    if fid_every:
        from viscoin_tpu_torch.eval.fid import fid_from_stats
        from viscoin_tpu_torch.train.gan import (
            accumulate_fake_fid_stats,
            accumulate_real_fid_stats,
            make_gan_fid_fns,
        )

        detector = _load_fid_detector(detector_path, device)
        fake_images_fn, real_images_fn = make_gan_fid_fns(cfg.batch_size, mesh)
        stats_real = accumulate_real_fid_stats(detector, real_images_fn, train_ds,
                                               cfg.batch_size, fid_samples, device=device,
                                               mesh=mesh)
        print(f"FID every {fid_every} it: {stats_real.num_items} real samples accumulated, "
              f"{fid_samples} fakes per estimate")

        def fid(i: int) -> float:
            stats_fake = accumulate_fake_fid_stats(detector, fake_images_fn, state.g_ema,
                                                   fold_seed(seed, _FID_TAG, i), fid_samples,
                                                   mesh=mesh)
            return fid_from_stats(stats_real, stats_fake)

    state_path = f"{output_weights}.train_state"
    resume_meta = {"batch_size": cfg.batch_size, "seed": seed, "augment": cfg.augment,
                   "compute_dtype": cfg.compute_dtype, "mirror": cfg.mirror,
                   "ema_rampup": cfg.ema_rampup}
    if cfg_name != "auto":
        resume_meta["cfg"] = cfg_name
    if resume_from:  # every rank reads the same state
        ckpt.restore_gan_train_state(state, resume_from, expect_meta=resume_meta)
    if mesh is not None:  # every rank starts from rank 0's weights and moments
        broadcast_tree(_gan_state_tensors(state), mesh)
    start = state.step
    if start:
        # Replay the position: only full batches become steps.
        steps_per_epoch = len(train_ds) // cfg.batch_size
        epochs_done, rem = divmod(start, steps_per_epoch)
        loader.skip_batches(epochs_done * len(loader) + rem)
    it = loop_iter(loader)

    def next_images():
        images, _ = next(it)
        while images.shape[0] != local_bs:
            images, _ = next(it)
        return to_device(images[:, rows], device)  # (b, H or this rank's rows, W, C)

    prefetcher = DevicePrefetcher(next_images, prefetch) if prefetch > 0 else None
    next_batch = prefetcher.next if prefetcher is not None else next_images
    try:
        for i in range(start, cfg.iterations):
            images = next_batch()
            state, metrics = step(state, images, draw_step(cfg, generator, seed, i, device, mesh))
            if (i % 100 == 0 or i == cfg.iterations - 1) and is_main(mesh):
                values = torch.stack([v.float().cpu() for v in metrics.values()]).double()
                logger.info(json.dumps({"iteration": i, **{
                    k: float(v) for k, v in zip(metrics, values)}}))
            if fid is not None and ((i > start and i % fid_every == 0)
                                    or i == cfg.iterations - 1):
                score = fid(i)
                if is_main(mesh):
                    logger.info(json.dumps({"iteration": i, "fid": score}))
                    print(f"it {i}: fid={score:.3f} ({fid_samples} fakes)")
            if snapshot_fn is not None and is_main(mesh) and (
                    i % snapshot_every == 0 or i == cfg.iterations - 1):
                from PIL import Image

                u8 = snapshot_fn(state.g_ema, fold_seed(seed, _SNAPSHOT_TAG)).cpu().numpy()
                n, h, w, c = u8.shape  # 16 -> a 4x4 grid
                grid = u8.reshape(4, 4, h, w, c).transpose(0, 2, 1, 3, 4).reshape(4 * h, 4 * w, c)
                Image.fromarray(np.ascontiguousarray(grid)).save(f"fakes_{i:06d}.png")
            if checkpoint_every and i > start and i % checkpoint_every == 0 and is_main(mesh):
                ckpt.save_gan_train_state(state, state_path, meta=resume_meta, async_save=True)
    finally:
        if prefetcher is not None:
            prefetcher.close()
        it.close()
    if is_main(mesh):
        ckpt.wait_for_saves()
        ckpt.save_gan_train_state(state, state_path, meta=resume_meta)
        ckpt.save_pytree(export_generator_vars(state), output_weights)
        print(f"saved EMA generator variables to {output_weights} (+ resumable train state at "
              f"{state_path})")
    ckpt.wait_for_saves(mesh)


def _gan_state_tensors(state) -> list[torch.Tensor]:
    """G, D and the EMA (parameters and buffers), both Adams' moments,
    w_avg, pl_mean and r_t, in an order every rank shares."""
    out = [t for m in (state.generator, state.discriminator, state.g_ema)
           for t in (*m.parameters(), *m.buffers())]
    for opt in (state.g_opt, state.d_opt):
        for p in (p for group in opt.param_groups for p in group["params"]):
            out += [v for k, v in opt.state.get(p, {}).items() if k != "step"]
    return out + [state.w_avg, state.pl_mean, state.ada_rt]
