"""VisCoIN ensemble training: one step.

Counterpart of ``viscoin_tpu/train/viscoin.py`` up to the step (the loop
``train_viscoin``, its eval, checkpoints and probe are not ported yet). One
step: the u8 batch is preprocessed on the device with a random horizontal
flip per sample; the frozen classifier f runs on the real images and the
synthetic ones (sampled from the frozen original ``Generator``, usually ahead
of time by :func:`make_sample_fakes`); Psi, Theta (with dropout) and the
adapted mapping are trained through the frozen synthesis network, f on the
reconstruction and LPIPS; the six-term loss takes one backward, and two Adam
optimizers (Psi + Theta, and the mapping) take one update each.

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
    recomputed, so the recompute sees the noise the forward saw.

``gradient_accumulation > 1`` and a device mesh are not ported (ROADMAP.md,
queue 1); they raise.
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
from viscoin_tpu_torch.train import losses as L

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
REMAT_TARGETS = ("lpips", "classifier", "gan")
_SAMPLER_TAG = 0x53414D50  # "SAMP": keeps sampler seeds apart from step seeds


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
    ``opt`` updates Psi and Theta, ``gan_opt`` the mapping."""

    step: int
    params: dict[str, dict[str, torch.nn.Parameter]]
    opt: torch.optim.Adam
    gan_opt: torch.optim.Adam


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
    Theta, and the mapping. The step sets their learning rate to
    ``schedule(count)`` before each update, count being the number of updates
    already taken, as optax evaluates a schedule."""
    if cfg.gradient_accumulation > 1:
        raise NotImplementedError("gradient_accumulation > 1 is not ported yet (ROADMAP.md, "
                                  "queue 1)")

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
    return TrainState(step=0, params=params, opt=opt, gan_opt=gan_opt)


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


def step_generator(seed: int, step: int, device="cuda") -> torch.Generator:
    """The generator of one training step, seeded from (seed, step): a
    resumed run draws the same flips, noise and dropout at the same step."""
    return torch.Generator(device=device).manual_seed(fold_seed(seed, step))


def fake_sample_keys(seed: int, group_start: int, k: int) -> list[int]:
    """Sampler seeds of steps [group_start, group_start + k):
    ``fold_seed(seed, step, TAG)``, apart from the step seeds."""
    return [fold_seed(seed, group_start + j, _SAMPLER_TAG) for j in range(k)]


def make_sample_fakes(generator_gan, cfg: VisCoINTrainingParams):
    """The sampler of the frozen original generator's synthetic batches.

    Returns ``sample(frozen, seeds) -> (K, batch_size, 3, H, W)`` in the
    compute dtype, K = len(seeds) (from :func:`fake_sample_keys`). Row k's
    latents are a function of seeds[k] alone; the synthesis runs once on the
    K * batch_size latents, with its noise drawn from a generator keyed by
    the group's first seed."""
    dt = _dtype(cfg.compute_dtype)

    @torch.no_grad()
    def sample(frozen: dict, seeds: list[int]) -> torch.Tensor:
        gen_module = frozen["generator"]
        device = next(gen_module.parameters()).device
        z = torch.cat([torch.randn((cfg.batch_size, generator_gan.z_dim), device=device,
                                   generator=torch.Generator(device=device).manual_seed(s))
                       for s in seeds]).to(dt)
        noise = torch.Generator(device=device).manual_seed(fold_seed(seeds[0], 1))
        fakes = gen_module(z, noise_mode="random", generator=noise)
        return fakes.to(dt).reshape(len(seeds), cfg.batch_size, *fakes.shape[1:])

    return sample


def make_loss_fn(models: VisCoINModels, generator_gan, lpips_module,
                 cfg: VisCoINTrainingParams):
    """The step's total-loss function (the five forwards and the six-term
    objective), factored out so that tests can differentiate exactly what
    the step differentiates.

    Returns ``loss_fn(params, frozen, real, labels, step, rng, fake=None,
    dropout_mask=None) -> (total, metrics)``: ``params`` as in
    :class:`TrainState`, ``real`` the preprocessed float batch, ``rng`` the
    step's ``torch.Generator``, ``fake`` a synthetic batch (None: sample the
    frozen original generator here), ``dropout_mask`` the explainer's keep
    mask (None: drawn from ``rng``)."""
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
        if fake is None:
            with torch.no_grad():
                z = torch.randn((B, generator_gan.z_dim), device=real.device, generator=rng)
                fake = frozen["generator"](z.to(dt), noise_mode="random", generator=rng)
        all_images = torch.cat([real, fake.to(dt)])

        classes, hidden = frozen["classifier"](all_images)
        classes = classes.float()
        phi, phi_prime = functional_call(modules["concept_extractor"],
                                         params_c["concept_extractor"], (tuple(hidden[-3:]),))
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

        ws = functional_call(modules["mapping"], params_c["mapping"], (phi, phi_prime))
        synthesis = frozen["synthesis"]
        if "gan" in remat:
            state = rng.get_state() if rng is not None else None

            def synth(ws):
                if state is not None:  # the recompute draws the forward's noise again
                    rng.set_state(state)
                return synthesis(ws, noise_mode="random", generator=rng)

            rebuilt = checkpoint(synth, ws, use_reentrant=False)
        else:
            rebuilt = synthesis(ws, noise_mode="random", generator=rng)
        rebuilt = post(rebuilt).to(dt)

        def f_rebuilt(x):
            return frozen["classifier"](x)[0]

        def lpips_fn(a, b):
            return frozen["lpips"](a.to(dt), b.to(dt)).float()

        if "classifier" in remat:
            rebuilt_classes = checkpoint(f_rebuilt, rebuilt, use_reentrant=False)
        else:
            rebuilt_classes = f_rebuilt(rebuilt)
        if "lpips" in remat:
            lpips_call = lambda a, b: checkpoint(lpips_fn, a, b, use_reentrant=False)  # noqa: E731
        else:
            lpips_call = lpips_fn

        rec_loss = L.reconstruction_loss(
            rebuilt.float(), all_images.float(), rebuilt_classes.float(), classes, lpips_call,
            lambda_classes=cfg.gamma, lambda_lpips=cfg.beta)
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
    generator itself). The state is updated in place and returned."""
    if mesh is not None:
        raise NotImplementedError("training over a device mesh is not ported yet (ROADMAP.md, "
                                  "queue 1)")
    schedule = make_lr_schedule(cfg.learning_rate, cfg.iterations)
    loss_fn = make_loss_fn(models, generator_gan, lpips_module, cfg)

    def train_step(state: TrainState, frozen, images_u8, labels, rng, fake=None,
                   dropout_mask=None):
        if external_fakes and fake is None:
            raise ValueError("this step takes its synthetic batch from outside (external_fakes)")
        if preprocess:
            flips = torch.rand(images_u8.shape[0], device=images_u8.device, generator=rng) < 0.5
            real = device_preprocess(images_u8, flips)
        else:
            real = images_u8
        state.opt.zero_grad(set_to_none=True)
        state.gan_opt.zero_grad(set_to_none=True)
        total, metrics = loss_fn(state.params, frozen, real, labels, state.step, rng, fake,
                                 dropout_mask)
        total.backward()
        lr = schedule(state.step)  # optax: the schedule at the count of updates taken
        for opt in (state.opt, state.gan_opt):
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
        state.step += 1
        return state, metrics

    return train_step
