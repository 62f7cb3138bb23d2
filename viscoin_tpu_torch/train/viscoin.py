"""VisCoIN ensemble training: the step and the loop.

Counterpart of ``viscoin_tpu/train/viscoin.py``. One step: the u8 batch is
preprocessed on the device with a random horizontal flip per sample; the
frozen classifier f runs on the real images and the synthetic ones (sampled
from the frozen original ``Generator``, usually ahead of time by
:func:`make_sample_fakes`); Psi, Theta (with dropout) and the adapted mapping
are trained through the frozen synthesis network, f on the reconstruction and
LPIPS; the six-term loss takes one backward, and two Adam optimizers (Psi +
Theta, and the mapping) take one update each, or, with
``gradient_accumulation = k > 1``, one update every k steps on the mean of
their gradients (``optax.MultiSteps``). :func:`train_viscoin` is the loop
around it: eval, checkpoints, the faithfulness probe and resume.

What differs from JAX, by design:

  * the trainable parameters are the bundle's own ``nn.Parameter``s
    (``TrainState.params`` holds them by name), updated in place by
    ``torch.optim.Adam``; JAX copies them into a functional state;
  * randomness comes from one ``torch.Generator`` per step
    (:func:`step_generator`, seeded by :func:`fold_seed` from the run's
    seed and the step, as ``jax.random.fold_in`` keys a JAX step); the
    numbers differ from JAX's streams, so the tests fix the noise and the
    dropout mask;
  * ``compute_dtype="bfloat16"`` keeps fp32 masters: the trainable
    parameters are cast per step (differentiably, through
    ``torch.func.functional_call``), the frozen modules once in
    :func:`make_frozen`, and the losses are computed in fp32;
  * ``remat`` maps to ``torch.utils.checkpoint``; the synthesis noise is
    drawn again from the same generator state when the synthesis is
    recomputed, so the recompute sees the noise the forward saw;
  * data parallelism (``mesh``, ``parallel/mesh.py``) runs one process per
    card, each on its slice of the global batch: the gradients are averaged
    over the ranks once per update and the logged losses are the global
    means, so the update is the global batch's, as under the JAX package's
    GSPMD (every loss is a mean over equal local batches). Each rank draws
    its own flips, noise, dropout and synthetic batch (its seeds fold the
    rank in; at world size 1 they are the one-process seeds);
  * model parallelism (a 2-D ``(data, model)`` mesh, ``parallel/spatial.py``)
    splits each data shard's images along H over its model ranks: every
    sharded plane of f, Psi, G and LPIPS holds this rank's rows, the
    exchanges and reductions are explicit, every loss term is whole on every
    rank of a model group, and the gradients are averaged over all the
    ranks (the gradient rule of ``parallel/spatial.py``). The ranks of a
    model group fold only their data index into their seeds, so they draw
    the same flips, noise planes, dropout mask and latents.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from viscoin_tpu_torch.data.transforms import device_preprocess
from viscoin_tpu_torch.models.bundle import VisCoINModels
from viscoin_tpu_torch.parallel.mesh import Mesh, all_mean, all_reduce_grads, broadcast_tree
from viscoin_tpu_torch.parallel.spatial import bundle_spatial, spatial_for
from viscoin_tpu_torch.train import losses as L
from viscoin_tpu_torch.utils import tracing

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
REMAT_TARGETS = ("lpips", "classifier", "gan")
_SAMPLER_TAG = 0x53414D50  # "SAMP": keeps sampler seeds apart from step seeds
_RANK_TAG = 0x52414E4B  # "RANK": a rank's own seeds under data parallelism
TRAIN_METRICS = ("acc_loss", "cr_loss", "of_loss", "ortho_loss", "rec_loss", "gan_loss",
                 "inter_loss")


@dataclass
class VisCoINTrainingParams:
    """Training parameters; the defaults are the CUB paper settings."""

    iterations: int = 100_000
    learning_rate: float = 1e-4
    cd_fid_iteration: int = 100
    batch_size: int = 8  # real images per step; as many synthetic ones are added
    alpha: float = 0.5  # output fidelity loss
    beta: float = 3.0  # LPIPS loss
    gamma: float = 0.1  # reconstruction classification loss
    delta: float = 0.2  # sparsity loss
    gradient_accumulation: int = 1
    compute_dtype: str = "float32"  # or "bfloat16", with fp32 masters
    remat: str = ""  # "+"-separated subset of lpips, classifier, gan
    fake_presample_steps: int = 2  # synthetic batches drawn K steps at a time


@dataclass
class TrainState:
    """``params`` maps "concept_extractor", "explainer" and "mapping" to the
    bundle's parameters by name (the fp32 masters, updated in place);
    ``opt`` updates Psi and Theta, ``gan_opt`` the mapping. ``step`` counts
    steps (micro-steps under gradient accumulation), as JAX's does."""

    step: int
    params: dict[str, dict[str, torch.nn.Parameter]]
    opt: torch.optim.Adam
    gan_opt: torch.optim.Adam
    # gradient_accumulation > 1: the running mean of the micro-steps'
    # gradients since the last update, by group and name (None otherwise).
    acc: dict[str, dict[str, torch.Tensor]] | None = None


def _dtype(name: str) -> torch.dtype:
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, got {name!r}")
    return COMPUTE_DTYPES[name]


def _remat_targets(remat: str) -> set[str]:
    targets = set(filter(None, (remat or "").replace(",", "+").split("+")))
    unknown = targets - set(REMAT_TARGETS)
    if unknown:
        raise ValueError(f"unknown remat targets {sorted(unknown)}; expected a subset of "
                         "lpips+classifier+gan")
    return targets


def make_lr_schedule(base_lr: float, iterations: int) -> Callable[[int], float]:
    """x0.8 every 1000 iterations after the first half."""
    half = iterations // 2

    def schedule(step: int) -> float:
        return base_lr * 0.8 ** max(0, (step - half) // 1000)

    return schedule


def make_optimizers(cfg: VisCoINTrainingParams, params: dict) -> tuple[torch.optim.Adam,
                                                                       torch.optim.Adam]:
    """Two Adams with optax's defaults (b1 0.9, b2 0.999, eps 1e-8): Psi +
    Theta, and the mapping. Before each update their learning rate is set to
    ``schedule(count * k)``, count being the number of updates already taken
    and k the gradient accumulation, as optax evaluates the JAX package's
    rescaled schedule (:func:`optimizer_update`)."""
    if cfg.gradient_accumulation < 1:
        raise ValueError(f"gradient_accumulation must be >= 1, got {cfg.gradient_accumulation}")

    def adam(groups):
        return torch.optim.Adam([p for g in groups for p in params[g].values()],
                                lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)

    return adam(("concept_extractor", "explainer")), adam(("mapping",))


def trainable_modules(models: VisCoINModels) -> dict[str, torch.nn.Module]:
    return {"concept_extractor": models.concept_extractor, "explainer": models.explainer,
            "mapping": models.gan.mapping}


def create_train_state(models: VisCoINModels, cfg: VisCoINTrainingParams) -> TrainState:
    params = {}
    for name, module in trainable_modules(models).items():
        params[name] = dict(module.named_parameters())
        for p in params[name].values():
            p.requires_grad_(True)
    opt, gan_opt = make_optimizers(cfg, params)
    acc = None
    if cfg.gradient_accumulation > 1:
        acc = {g: {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for n, p in grp.items()} for g, grp in params.items()}
    return TrainState(step=0, params=params, opt=opt, gan_opt=gan_opt, acc=acc)


def _average_grads(params: list, mesh: Mesh | None) -> None:
    """Replace the ``.grad`` of each parameter that has one by its mean over
    the ranks (one collective per dtype); on a 2-D mesh over all of them,
    which is the gradient rule of ``parallel/spatial.py``."""
    if mesh is None:
        return
    with_grad = [p for p in params if p.grad is not None]
    for p, g in zip(with_grad, all_reduce_grads([p.grad for p in with_grad], mesh)):
        p.grad = g


@torch.no_grad()
def optimizer_update(state: TrainState, cfg: VisCoINTrainingParams, schedule,
                     mesh: Mesh | None = None) -> bool:
    """After a backward: the optimizer part of one step, with
    ``optax.MultiSteps`` semantics. For k = ``cfg.gradient_accumulation`` > 1
    each micro-step folds its gradients into a running mean
    (acc += (g - acc) / (n + 1), n the micro-step within the window), and on
    the k-th both Adams step on that mean and the buffers reset; between,
    the parameters and the Adam moments do not move. The learning rate is
    ``schedule(updates_taken * k)``. With a ``mesh`` the gradients of an
    update (the accumulated mean, after the last micro-step) are first
    averaged over the ranks. Advances ``state.step``; returns True when the
    parameters were updated."""
    k = cfg.gradient_accumulation
    micro = state.step
    state.step += 1
    leaves = [(g, n, p) for g, grp in state.params.items() for n, p in grp.items()]
    if k > 1:
        n_in = micro % k
        for g, n, p in leaves:
            acc = state.acc[g][n]
            grad = p.grad if p.grad is not None else torch.zeros_like(acc)
            acc.add_((grad - acc) / (n_in + 1))
            p.grad = None
        if n_in != k - 1:
            return False
        for g, n, p in leaves:
            p.grad = state.acc[g][n]
    _average_grads([p for _, _, p in leaves], mesh)
    lr = schedule((micro // k) * k)  # optax: the schedule at the count of updates taken
    for opt in (state.opt, state.gan_opt):
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
    if k > 1:
        for g, n, p in leaves:
            p.grad = None
            state.acc[g][n].zero_()
    return True


def make_frozen(models: VisCoINModels, generator, lpips, compute_dtype: str | None = None) -> dict:
    """Every module the step does not train: the classifier, the synthesis
    network, the original ``generator`` (None when every synthetic batch
    comes from outside the step) and ``lpips``, in eval mode with
    ``requires_grad`` off. In fp32 they are the modules given (so this turns
    their gradients off); in another compute dtype, copies cast once."""
    frozen = {"classifier": models.classifier, "synthesis": models.gan.synthesis,
              "generator": generator, "lpips": lpips}
    dt = _dtype(compute_dtype or "float32")
    for key, module in frozen.items():
        if module is None:
            continue
        if dt != torch.float32:
            module = copy.deepcopy(module).to(dt)
        frozen[key] = module.eval().requires_grad_(False)
    return frozen


def make_cast(compute_dtype: str) -> Callable[[dict], dict]:
    """Cast the fp32 leaves of a {group: {name: tensor}} dict to the compute
    dtype, differentiably; the identity in fp32."""
    dt = _dtype(compute_dtype)

    def cast(params: dict) -> dict:
        if dt == torch.float32:
            return params
        return {g: {n: p.to(dt) if p.dtype == torch.float32 else p for n, p in group.items()}
                for g, group in params.items()}

    return cast


def fold_seed(seed: int, *data: int) -> int:
    """A 63-bit seed that is a pure function of (seed, *data): the
    counterpart of ``jax.random.fold_in`` for ``torch.Generator`` seeds."""
    words = np.random.SeedSequence([int(seed), *map(int, data)]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def rank_seed(seed: int, mesh: Mesh | None) -> int:
    """A rank's own seed under data parallelism (``seed`` itself without a
    mesh or with one data shard, so one process draws the one-process
    numbers): its data index folded in, which the ranks of a model group
    share."""
    data = None if mesh is None else mesh.data_axis
    if data is None or data.world == 1:
        return seed
    return fold_seed(seed, _RANK_TAG, data.rank)


def step_generator(seed: int, step: int, device="cuda", mesh: Mesh | None = None):
    """The generator of one training step, seeded from (seed, step) and the
    rank: a resumed run draws the same flips, noise and dropout at the same
    step."""
    return torch.Generator(device=device).manual_seed(rank_seed(fold_seed(seed, step), mesh))


def fake_sample_keys(seed: int, group_start: int, k: int, mesh: Mesh | None = None) -> list[int]:
    """Sampler seeds of steps [group_start, group_start + k):
    ``fold_seed(seed, step, TAG)``, apart from the step seeds, and the
    rank's own under data parallelism."""
    return [rank_seed(fold_seed(seed, group_start + j, _SAMPLER_TAG), mesh) for j in range(k)]


def make_sample_fakes(generator_gan, cfg: VisCoINTrainingParams, mesh: Mesh | None = None):
    """The sampler of the frozen original generator's synthetic batches.

    Returns ``sample(frozen, seeds) -> (K, b, 3, H, W)`` in the compute
    dtype, K = len(seeds) (from :func:`fake_sample_keys`), b the rank's rows
    of ``cfg.batch_size`` (all of them without a ``mesh``). Row k's latents
    are a function of seeds[k] alone; the synthesis runs once on the K * b
    latents, with its noise drawn from a generator keyed by the group's
    first seed. On a 2-D mesh the synthesis is H-sharded and H is this
    rank's rows of the image, as the step takes them."""
    dt = _dtype(cfg.compute_dtype)
    rows = cfg.batch_size if mesh is None else mesh.local(cfg.batch_size)
    sp = spatial_for(mesh, generator_gan.img_resolution)

    @torch.no_grad()
    def sample(frozen: dict, seeds: list[int]) -> torch.Tensor:
        with tracing.span("sample"):
            gen_module = frozen["generator"]
            device = next(gen_module.parameters()).device
            z = torch.cat([torch.randn((rows, generator_gan.z_dim), device=device,
                                       generator=torch.Generator(device=device).manual_seed(s))
                           for s in seeds]).to(dt)
            noise = torch.Generator(device=device).manual_seed(fold_seed(seeds[0], 1))
            fakes = gen_module(z, noise_mode="random", generator=noise, spatial=sp)
            return fakes.to(dt).reshape(len(seeds), rows, *fakes.shape[1:])

    return sample


def make_loss_fn(models: VisCoINModels, generator_gan, lpips_module,
                 cfg: VisCoINTrainingParams, mesh=None):
    """The step's total-loss function (the five forwards and the six-term
    objective), factored out so that tests can differentiate exactly what
    the step differentiates.

    Returns ``loss_fn(params, frozen, real, labels, step, rng, fake=None,
    dropout_mask=None) -> (total, metrics)``: ``params`` as in
    :class:`TrainState`, ``real`` the preprocessed float batch, ``rng`` the
    step's ``torch.Generator``, ``fake`` a synthetic batch (None: sample the
    frozen original generator here), ``dropout_mask`` the explainer's keep
    mask (None: drawn from ``rng``). On a 2-D ``mesh`` the images (``real``,
    ``fake``) are this rank's rows; the total and the metrics are whole."""
    del lpips_module  # frozen["lpips"] is the module the step runs
    dt = _dtype(cfg.compute_dtype)
    cast = make_cast(cfg.compute_dtype)
    remat = _remat_targets(cfg.remat)
    modules = trainable_modules(models)
    post = models.gan._post

    def loss_fn(params, frozen, real, labels, step, rng, fake=None, dropout_mask=None):
        params_c = cast(params)
        real = real.to(dt)
        B = real.shape[0]
        sp = bundle_spatial(models, mesh, real.shape[3])
        if fake is None:
            with torch.no_grad():
                z = torch.randn((B, generator_gan.z_dim), device=real.device, generator=rng)
                fake = frozen["generator"](z.to(dt), noise_mode="random", generator=rng,
                                           spatial=sp)
        all_images = torch.cat([real, fake.to(dt)])

        with tracing.span("viscoin_step.classifier"):
            classes, hidden = frozen["classifier"](all_images, spatial=sp)
            classes = classes.float()
        with tracing.span("viscoin_step.concepts"):
            phi, phi_prime = functional_call(modules["concept_extractor"],
                                             params_c["concept_extractor"],
                                             (tuple(hidden[-3:]),), {"spatial": sp})
            explainer_classes = functional_call(
                modules["explainer"], params_c["explainer"], (phi,),
                dict(train=True, generator=rng, dropout_mask=dropout_mask)).float()

            # Losses in fp32.
            acc_loss = L.softmax_cross_entropy(classes[:B], labels)
            gate = float(step > cfg.cd_fid_iteration)
            cr_loss = gate * cfg.delta * L.concept_regularization_loss(phi.float())
            of_loss = gate * cfg.alpha * L.output_fidelity_loss(classes, explainer_classes)
            # Orthogonality on the fp32 master weight.
            ortho_loss = L.concept_orthogonality_loss(params["concept_extractor"]["conv5.weight"])

        with tracing.span("viscoin_step.synthesis"):
            ws = functional_call(modules["mapping"], params_c["mapping"], (phi, phi_prime))
            synthesis = frozen["synthesis"]
            if "gan" in remat:
                state = rng.get_state() if rng is not None else None

                def synth(ws):
                    if state is not None:  # the recompute draws the forward's noise again
                        rng.set_state(state)
                    return synthesis(ws, noise_mode="random", generator=rng, spatial=sp)

                rebuilt = checkpoint(synth, ws, use_reentrant=False)
            else:
                rebuilt = synthesis(ws, noise_mode="random", generator=rng, spatial=sp)
            rebuilt = post(rebuilt, sp).to(dt)

        def f_rebuilt(x):
            return frozen["classifier"](x, spatial=sp)[0]

        def lpips_fn(a, b):
            return frozen["lpips"](a.to(dt), b.to(dt), spatial=sp).float()

        with tracing.span("viscoin_step.f_rebuilt"):
            if "classifier" in remat:
                rebuilt_classes = checkpoint(f_rebuilt, rebuilt, use_reentrant=False)
            else:
                rebuilt_classes = f_rebuilt(rebuilt)
        if "lpips" in remat:
            lpips_call = lambda a, b: checkpoint(lpips_fn, a, b, use_reentrant=False)  # noqa: E731
        else:
            lpips_call = lpips_fn

        with tracing.span("viscoin_step.lpips"):
            rec_loss = L.reconstruction_loss(
                rebuilt.float(), all_images.float(), rebuilt_classes.float(), classes,
                lpips_call, lambda_classes=cfg.gamma, lambda_lpips=cfg.beta, spatial=sp)
            gan_loss = L.gan_regularization_loss(ws.float(), params["mapping"]["fixed_w_avg"])

            total = acc_loss + cr_loss + of_loss + ortho_loss + rec_loss + gan_loss
            metrics = {"acc_loss": acc_loss, "cr_loss": cr_loss, "of_loss": of_loss,
                       "ortho_loss": ortho_loss, "rec_loss": rec_loss, "gan_loss": gan_loss,
                       "inter_loss": L.cross_cross_entropy_loss(rebuilt_classes.float(), classes),
                       "total_loss": total}
            return total, {k: torch.as_tensor(v).detach() for k, v in metrics.items()}

    return loss_fn


def make_train_step(models: VisCoINModels, generator_gan, lpips_module,
                    cfg: VisCoINTrainingParams, preprocess: bool = True,
                    external_fakes: bool = False, mesh=None):
    """Build the train step.

    Returns ``step(state, frozen, images_u8, labels, rng, fake=None,
    dropout_mask=None) -> (state, metrics)``: ``images_u8`` (B, H, W, 3)
    uint8 on the device (or, without ``preprocess``, the float NCHW batch),
    ``labels`` (B,), ``rng`` the step's generator (:func:`step_generator`),
    ``fake`` (B, 3, H, W) from :func:`make_sample_fakes`, required with
    ``external_fakes`` (without, the step samples the frozen original
    generator itself). The state is updated in place and returned.

    With a data-parallel ``mesh`` the inputs are this rank's slice of the
    global batch, the update takes the gradients' mean over the ranks and
    the metrics are the global means (one more collective). On a 2-D mesh
    the images are also this rank's rows along H (``fake`` too)."""
    schedule = make_lr_schedule(cfg.learning_rate, cfg.iterations)
    loss_fn = make_loss_fn(models, generator_gan, lpips_module, cfg, mesh)

    def train_step(state: TrainState, frozen, images_u8, labels, rng, fake=None,
                   dropout_mask=None):
        if external_fakes and fake is None:
            raise ValueError("this step takes its synthetic batch from outside (external_fakes)")
        with tracing.span("viscoin_step"):
            with tracing.span("viscoin_step.preprocess"):
                if preprocess:
                    flips = torch.rand(images_u8.shape[0], device=images_u8.device,
                                       generator=rng) < 0.5
                    real = device_preprocess(images_u8, flips)
                else:
                    real = images_u8
            state.opt.zero_grad(set_to_none=True)
            state.gan_opt.zero_grad(set_to_none=True)
            total, metrics = loss_fn(state.params, frozen, real, labels, state.step, rng, fake,
                                     dropout_mask)
            with tracing.span("viscoin_step.backward"):
                total.backward()
            with tracing.span("viscoin_step.update"):
                optimizer_update(state, cfg, schedule, mesh)
            if mesh is not None:
                metrics = dict(zip(metrics, all_mean(torch.stack(list(metrics.values())), mesh)))
            return state, metrics

    return train_step


def _check_device(device, models) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_viscoin(device='cuda'): no CUDA device is available; pass "
                           "device='cpu' to train with the plain versions on the CPU")
    have = next(models.parameters()).device
    if have.type != device.type or (device.index is not None and have.index != device.index):
        raise ValueError(f"the bundle lives on {have}, not on the training device {device}")
    return have


def train_viscoin(models: VisCoINModels, generator_gan, lpips_module, train_loader, test_loader,
                  cfg: VisCoINTrainingParams, mesh=None, seed: int = 0,
                  checkpoint_dir: str = ".", eval_every: int = 2000,
                  checkpoint_every: int = 20_000, faithfulness_every: int = 25_000,
                  fid_detector=None, resume_from: str | None = None,
                  profile_dir: str | None = None, prefetch: int = 0,
                  timings: dict | None = None, stop_after: int | None = None,
                  device="cuda") -> VisCoINModels:
    """The outer training loop: the step, a full test eval every
    ``eval_every`` iterations (i = 0 included; one jsonl record each), the
    bundle and the training state every ``checkpoint_every`` (written in the
    background), the 200-image faithfulness probe every
    ``faithfulness_every`` (i > 0); 0 disables a cadence. The modules carry
    their weights: ``generator_gan`` is the frozen original generator,
    ``lpips_module`` LPIPS; all live on ``device`` ("cuda" unless the CPU is
    asked for).

    ``resume_from``: a training state saved by this loop; the run continues
    exactly where it stopped (the loader is fast-forwarded, the step seeds
    are (seed, i), the synthetic groups are aligned to absolute steps).
    ``prefetch`` > 0 loads and places the next batches on a background
    thread (one producer, so the order is unchanged). ``timings``: a dict
    that collects the host's seconds per phase ("steps", "eval",
    "checkpoint", "probe"), with "n_<phase>" counts, "max_<phase>" and,
    under "seconds", every duration (``utils/tracing.py::timed``). Nothing
    synchronises the card for them: "steps" is the time the host took to
    enqueue the step's work (the card may finish it later), "eval" holds
    the eval's reads back. ``stop_after``: at most this many steps in
    this call, on the full ``cfg.iterations`` schedule. ``profile_dir``: a
    torch.profiler trace of steps 2 to 5 of this call (``trace.json``), the
    phases named by the spans of ``utils/tracing.py``.

    ``mesh``: data parallelism (every rank calls this with its own mesh).
    ``cfg.batch_size`` stays the global batch; ``train_loader`` and
    ``test_loader`` must be sharded over the mesh (``DataLoader(shard=(rank,
    world))``; the test loader with ``pad_final`` when its last batch is
    ragged). The weights start from rank 0's (after any resume); the eval
    runs on every rank, while the jsonl records, the checkpoints, the probe
    and the profile are rank 0's; every rank returns once rank 0's writes
    are on disk. A resume replays the unbroken run exactly over the same
    number of ranks; over another it continues with other random draws
    (each rank's seeds fold its rank in). On a 2-D mesh the loaders are
    sharded over its data axis (``DataLoader(shard=(data index, data
    shards))``), each rank places its H rows of every batch, and global
    rank 0 writes."""
    import json
    import os

    from viscoin_tpu_torch.data.loader import DevicePrefetcher, loop_iter
    from viscoin_tpu_torch.eval.viscoin import (
        faithfulness_probe,
        make_faithfulness_fn,
        make_test_step,
        test_viscoin,
        to_device,
    )
    from viscoin_tpu_torch.parallel.mesh import is_main
    from viscoin_tpu_torch.utils import checkpoints as ckpt
    from viscoin_tpu_torch.utils.logging import get_logger

    device = _check_device(device, models)
    logger = get_logger()
    loader_bs = getattr(train_loader, "batch_size", cfg.batch_size)
    if loader_bs != cfg.batch_size:
        raise ValueError(f"train_loader.batch_size={loader_bs} != "
                         f"cfg.batch_size={cfg.batch_size}")
    # A sharded loader yields this rank's slice of every global batch: one
    # loader per data shard of the mesh, exactly.
    data = None if mesh is None else mesh.data_axis
    world = 1 if data is None else data.world
    shard = getattr(train_loader, "shard", (0, 1))
    if shard != (0 if data is None else data.rank, world):
        raise ValueError(f"train_loader.shard={shard}: a run over {world} data shard(s) needs "
                         f"DataLoader(shard=(data index, {world})) on each (a sharded loader "
                         "needs a mesh)")
    if mesh is not None and getattr(test_loader, "shard", (0, 1))[1] != world:
        raise ValueError(f"test_loader.shard world {getattr(test_loader, 'shard', (0, 1))[1]} "
                         f"!= the mesh's {world}: the in-loop eval feeds every rank its shard "
                         "of each global test batch")
    local_rows = cfg.batch_size // world
    if hasattr(train_loader, "dataset") and len(train_loader.dataset) < cfg.batch_size:
        raise ValueError(f"dataset has {len(train_loader.dataset)} samples < batch_size="
                         f"{cfg.batch_size}: no full batch can ever be formed")
    K = max(1, cfg.fake_presample_steps)
    if mesh is not None:  # every rank starts from rank 0's weights
        broadcast_tree([t for m in (models, generator_gan, lpips_module) if m is not None
                        for t in (*m.parameters(), *m.buffers())], mesh)
    step_fn = make_train_step(models, generator_gan, lpips_module, cfg, external_fakes=True,
                              mesh=mesh)
    sample_fakes = make_sample_fakes(generator_gan, cfg, mesh)
    frozen = make_frozen(models, generator_gan, lpips_module, compute_dtype=cfg.compute_dtype)
    state = create_train_state(models, cfg)
    # The invariants of an exact replay, saved with every training state; a
    # mismatch on resume is an error, not a silently different stream.
    resume_meta = {"fake_presample_steps": K, "batch_size": cfg.batch_size, "seed": seed,
                   "compute_dtype": str(cfg.compute_dtype)}
    if resume_from:  # every rank reads the same state; rank 0's then stands
        state = ckpt.restore_train_state(state, resume_from, expect_meta=resume_meta)
        if mesh is not None:
            broadcast_tree(_state_tensors(state), mesh)

    start = state.step
    if start and hasattr(train_loader, "skip_batches"):
        # An epoch yields len(loader) batches, of which only the full ones
        # are steps (a ragged last batch is skipped below): fast-forward to
        # the batch the unbroken run would be on.
        steps_per_epoch = len(train_loader.dataset) // cfg.batch_size
        epochs_done, rem = divmod(start, steps_per_epoch)
        train_loader.skip_batches(epochs_done * len(train_loader) + rem)
    train_iter = loop_iter(train_loader)

    model_axis = None if mesh is None else mesh.model_axis

    def pull_and_place():
        images, labels = next(train_iter)
        while images.shape[0] != local_rows:  # skip ragged final batches
            images, labels = next(train_iter)
        if model_axis is not None:  # this rank's rows of the (B, H, W, 3) batch
            images = images[:, model_axis.rows(model_axis.local(images.shape[1]))]
        return to_device(images, device), to_device(labels.astype(np.int64), device)

    prefetcher = DevicePrefetcher(pull_and_place, prefetch) if prefetch > 0 else None
    next_batch = prefetcher.next if prefetcher is not None else pull_and_place

    # The eval, the checkpoints and the probe read the bundle itself. The JAX
    # loop's sync_models() first copies the trained parameters back into it;
    # here they are the bundle's own, updated in place, so nothing is copied.
    eval_step = probe_fn = None
    fake_group, fake_group_start = None, -1
    profiler = None
    end = cfg.iterations if stop_after is None else min(cfg.iterations, start + stop_after)
    try:
        for i in range(start, end):
            if profile_dir and is_main(mesh) and i == start + 2:  # past the one-off costs
                from torch.profiler import ProfilerActivity, profile

                activities = [ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(ProfilerActivity.CUDA)
                profiler = profile(activities=activities)
                profiler.__enter__()
            with tracing.timed(None, timings, "steps"):
                with tracing.span("loop.data"):
                    images, labels = next_batch()
                group = (i // K) * K  # aligned to absolute steps: any resume regenerates it
                if fake_group_start != group:
                    fake_group = sample_fakes(frozen, fake_sample_keys(seed, group, K, mesh))
                    fake_group_start = group
                state, metrics = step_fn(state, frozen, images, labels,
                                         step_generator(seed, i, device, mesh),
                                         fake_group[i - group])
            if profiler is not None and i == start + 5:
                _stop_profiler(profiler, profile_dir)
                profiler = None

            if eval_every and i % eval_every == 0:
                with tracing.timed("loop.eval", timings, "eval"):
                    values = torch.stack([metrics[k] for k in TRAIN_METRICS]).double().cpu()
                    record = {f"train_{k}": float(v) for k, v in zip(TRAIN_METRICS, values)}
                    if eval_step is None:
                        eval_step = make_test_step(models, lpips_module, mesh)
                    results = test_viscoin(models, lpips_module, test_loader,
                                           compute_fid=fid_detector is not None,
                                           fid_detector=fid_detector, verbose=False, mesh=mesh,
                                           step=eval_step)
                    record.update({f"test_{k}": v for k, v in results.__dict__.items()})
                    if is_main(mesh):  # one jsonl log, not one per rank
                        logger.info(json.dumps(record))

            if checkpoint_every and i % checkpoint_every == 0 and is_main(mesh):
                with tracing.timed("loop.checkpoint", timings, "checkpoint"):
                    ckpt.save_viscoin(models, os.path.join(
                        checkpoint_dir,
                        f"viscoin{i // checkpoint_every}-{cfg.iterations // checkpoint_every}"),
                        async_save=True)
                    ckpt.save_train_state(state, os.path.join(checkpoint_dir, "train_state"),
                                          meta=resume_meta, async_save=True)

            if faithfulness_every and i % faithfulness_every == 0 and i > 0 and is_main(mesh):
                with tracing.timed("loop.probe", timings, "probe"):
                    if probe_fn is None:
                        probe_fn = make_faithfulness_fn(models)
                    ds = test_loader.dataset
                    probe_rng = np.random.default_rng((seed, i))  # the same after a resume
                    idx = probe_rng.choice(len(ds), min(200, len(ds)), replace=False)
                    images_u8 = np.stack([np.asarray(ds[int(j)][0]) for j in idx])
                    probs = faithfulness_probe(models, images_u8, fn=probe_fn)
                    print("Faithfullness stats (probability of best concept after "
                          f"reconstruction): mean = {np.mean(probs)} --- std = {np.std(probs)}")
    finally:
        # Every exit (a failing step, an interrupt, an I/O error) stops the
        # producers: the prefetcher joins its thread, then the loader's
        # iterator closes (which stops and joins its own producer).
        if prefetcher is not None:
            prefetcher.close()
        train_iter.close()
        if profiler is not None:
            _stop_profiler(profiler, profile_dir)
    ckpt.wait_for_saves(mesh)  # rank 0's checkpoints are on disk before any rank returns
    return models


def _state_tensors(state: TrainState) -> list[torch.Tensor]:
    """The trainable parameters, the Adam moments and the accumulation
    buffers, in an order every rank shares (the Adams' step counts, host
    scalars, are left out)."""
    out = [p for grp in state.params.values() for p in grp.values()]
    for opt in (state.opt, state.gan_opt):
        for p in (p for group in opt.param_groups for p in group["params"]):
            out += [v for k, v in opt.state.get(p, {}).items() if k != "step"]
    if state.acc is not None:
        out += [a for grp in state.acc.values() for a in grp.values()]
    return out


def _stop_profiler(profiler, profile_dir: str) -> None:
    import os

    profiler.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    profiler.export_chrome_trace(path)
    print(f"profiler trace written to {path}")
