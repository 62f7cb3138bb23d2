"""StyleGAN2 adversarial training: generator and discriminator steps.

Counterpart of ``viscoin_tpu/train/gan.py``: the non-saturating logistic
losses, the lazy R1 penalty (every ``r1_interval`` steps, through the
augmentation pipe) and the lazy path-length penalty (every ``ppl_interval``
steps, with NVlabs' non-detached ``pl_mean``), both second-order, style
mixing, ``w_avg`` tracking, the generator weight EMA, ADA
(``train/augment.py``) and mixed precision with fp32 masters.

What differs from JAX, by design:

  * the generator and discriminator are ``nn.Module``s whose parameters
    are the fp32 masters, updated in place by two ``torch.optim.Adam`` (the
    lazy-regularisation correction of lr and betas as in JAX); the EMA is a
    third module; gradients are taken with ``torch.autograd.grad`` against
    explicit parameter lists, so the G phase never touches D's gradients;
  * ``lax.cond`` is a Python ``if`` on the host step counter: a step off
    the R1 or PPL cadence does not run that regulariser at all;
  * the random numbers of a step are drawn apart from their use
    (:func:`draw_step`, from generators seeded by ``fold_seed(seed, step)``)
    and passed to the step, so a test can hand it JAX's numbers and a
    resumed run draws the same ones; the synthesis noise comes from
    ``torch.Generator``s seeded in the draws;
  * ``ada_p`` lives on the host (the augmentation draws compare with it);
    the r_t accumulator stays on the card and is read once per
    ``ada_interval`` steps.

The in-loop FID (``make_gan_fid_fns``, ``accumulate_*_fid_stats``) samples
the EMA generator with latents and synthesis noise from generators seeded
per batch, as the draws of a step are.

Data parallelism (``mesh``, ``parallel/mesh.py``): one process per card,
each on its slice of the global batch. The G and D gradients are averaged
over the ranks (one collective each per step); the minibatch stddev groups
span the ranks as under the JAX package's GSPMD; the path-length mean is
the global one, differentiably (``all_mean``); ADA's r_t and ``w_avg``'s
batch mean are global means; each rank's draws are its rows of the global
batch's, and its synthesis noise its own. The FID samples are sharded and
the features gathered.

Model parallelism (a 2-D ``(data, model)`` mesh, ``parallel/spatial.py``):
each data shard's images are split along H over its model ranks. G's
synthesis, the ADA pipe's output, D's planes, R1's gradient and the
path-length projection hold this rank's rows; the warp and D's 4² epilogue
read gathered whole planes, so the logits, and every loss term, are whole on
every rank of a model group (the gradient rule of ``parallel/spatial.py``).
A rank's gradient of a replicated input from a value that is whole on every
rank is that of ``model`` times it (R1's, divided by ``model``); from a value
it holds a part of, its part (the path length's, summed over the model
group). The ranks of a model group share their data index's draws and
noise seeds; the batch statistics count each image once (the data axis's
global batch). The FID fakes are sampled whole by every rank of a model
group and the features gathered over the data axis.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from viscoin_tpu_torch.models.stylegan import num_ws_for_resolution
from viscoin_tpu_torch.parallel import spatial as S
from viscoin_tpu_torch.parallel.mesh import Mesh, all_gather_batch, all_mean, all_reduce_grads
from viscoin_tpu_torch.train.augment import AugmentDraws, ada_update, augment, draw_augment
from viscoin_tpu_torch.train.viscoin import fold_seed, make_cast, rank_seed
from viscoin_tpu_torch.utils import tracing

_NOISE_TAGS = {"g": 1, "d": 2, "ppl": 3}  # synthesis noise generators of a step's phases
_DEVICE_TAG = 0x44455643  # "DEVC": the device generator of a step's tensors


@dataclass
class GANTrainingParams:
    """The JAX package's defaults (``GANTrainingParams``)."""

    iterations: int = 100_000
    learning_rate: float = 2.5e-3
    beta1: float = 0.0
    beta2: float = 0.99
    r1_gamma: float = 1.0
    r1_interval: int = 16  # lazy R1 cadence (D)
    style_mixing_prob: float = 0.9
    ppl_weight: float = 2.0
    ppl_interval: int = 4  # lazy path-length cadence (G)
    ppl_decay: float = 0.01  # EMA decay of the path-length target
    w_avg_beta: float = 0.995
    ema_kimg: float = 10.0  # generator weight EMA half-life (thousand images)
    ema_rampup: float = 0.0  # > 0 caps the half-life at rampup * images seen
    batch_size: int = 16
    augment: str = "ada"  # "ada", "fixed" (constant augment_p) or "none"
    augment_p: float = 0.0
    ada_target: float = 0.6
    ada_interval: int = 4
    ada_kimg: float = 500.0
    mirror: bool = True  # x-flip half of the real images
    compute_dtype: str = "float32"  # or "bfloat16", with fp32 masters and fp32 losses


@dataclass
class GANTrainState:
    """``generator`` and ``discriminator`` hold the fp32 masters (updated in
    place); ``g_ema`` the EMA of the generator's parameters; ``w_avg`` the
    tracked mean mapping output (fp32, on the device), ``pl_mean`` the
    path-length target (0-d, device), ``ada_p`` the augmentation
    probability (0-d fp32, host), ``ada_rt`` the r_t accumulator (0-d,
    device). ``step`` counts steps."""

    step: int
    generator: torch.nn.Module
    discriminator: torch.nn.Module
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    g_ema: torch.nn.Module
    w_avg: torch.Tensor
    pl_mean: torch.Tensor
    ada_p: torch.Tensor
    ada_rt: torch.Tensor

    def g_params(self) -> dict[str, torch.nn.Parameter]:
        return dict(self.generator.named_parameters())

    def d_params(self) -> dict[str, torch.nn.Parameter]:
        return dict(self.discriminator.named_parameters())


def _optimizers(cfg: GANTrainingParams, g_params, d_params):
    """G's and D's Adam with the lazy-regularisation correction: a
    regulariser that runs every N > 1 steps scales lr by mb = N / (N + 1)
    and raises the betas to the power mb (G: the PPL cadence, D: the R1
    cadence; a disabled regulariser, weight 0, no correction)."""
    def adam(params, interval: int, enabled: bool):
        mb = interval / (interval + 1) if enabled and interval > 1 else 1.0
        return torch.optim.Adam(list(params), lr=cfg.learning_rate * mb,
                                betas=(cfg.beta1 ** mb, cfg.beta2 ** mb), eps=1e-8)

    return (adam(g_params, cfg.ppl_interval, cfg.ppl_weight > 0),
            adam(d_params, cfg.r1_interval, cfg.r1_gamma > 0))


def create_gan_train_state(generator, discriminator, cfg: GANTrainingParams) -> GANTrainState:
    """The state of a fresh run around the modules (which carry their
    weights: random from ``init_models``, or carried over): both Adams, the
    EMA copy, w_avg = 0, pl_mean = 0, ada_p = ``augment_p``, r_t = 0."""
    device = next(generator.parameters()).device
    for module in (generator, discriminator):
        module.train().requires_grad_(True)
    g_opt, d_opt = _optimizers(cfg, generator.parameters(), discriminator.parameters())
    g_ema = copy.deepcopy(generator).eval().requires_grad_(False)
    return GANTrainState(
        step=0, generator=generator, discriminator=discriminator, g_opt=g_opt, d_opt=d_opt,
        g_ema=g_ema, w_avg=torch.zeros(generator.w_dim, device=device),
        pl_mean=torch.zeros((), device=device),
        ada_p=torch.tensor(cfg.augment_p, dtype=torch.float32),
        ada_rt=torch.zeros((), device=device))


@torch.no_grad()
def export_generator_vars(state: GANTrainState) -> dict:
    """The EMA generator's variables in the JAX package's layout ({params,
    noise, moving_stats}), with the tracked w_avg as
    ``moving_stats/mapping/w_avg``: what ``train viscoin`` and JAX's
    ``restore_pytree`` read."""
    from viscoin_tpu_torch.utils.weights import module_to_jax_tree

    tree = module_to_jax_tree(state.g_ema)
    tree["moving_stats"] = {"mapping": {"w_avg": state.w_avg.float().cpu().numpy()}}
    return tree


@torch.no_grad()
def warm_start_gan_state(state: GANTrainState, gvars: dict, d_params: dict | None = None):
    """Transfer-learning init: the generator's variables (JAX layout,
    {params[, noise][, moving_stats]}) into both the generator and its EMA,
    w_avg from ``moving_stats`` (kept when absent), the noise buffers where
    given, and the discriminator's params where given. Optimizers, step,
    pl_mean and the ADA state stay fresh. A shape or key mismatch raises.
    Returns ``state``."""
    from viscoin_tpu_torch.utils.weights import tree_to_state_dict

    _load_checked("generator params", state.generator,
                  tree_to_state_dict({k: v for k, v in gvars.items()
                                      if k in ("params", "noise")}),
                  partial_buffers=True)
    state.g_ema.load_state_dict(state.generator.state_dict())
    w_avg = gvars.get("moving_stats", {}).get("mapping", {}).get("w_avg")
    if w_avg is not None:
        state.w_avg.copy_(torch.as_tensor(np.asarray(w_avg, np.float32)))
    if d_params is not None:
        _load_checked("discriminator params", state.discriminator,
                      tree_to_state_dict({"params": d_params}))
    return state


def _load_checked(name: str, module, sd: dict, partial_buffers: bool = False) -> None:
    own = module.state_dict()
    params = {n for n, _ in module.named_parameters()}
    missing = sorted(k for k in own.keys() - sd.keys() if k in params or not partial_buffers)
    unexpected = sorted(sd.keys() - own.keys())
    if missing or unexpected:
        raise ValueError(f"{name}: loaded tree does not match this model config (wrong "
                         f"resolution / channel_base / channel_max?): missing {missing[:5]}, "
                         f"unexpected {unexpected[:5]}")
    for key, arr in sd.items():
        if tuple(own[key].shape) != arr.shape:
            raise ValueError(f"{name}: loaded leaf {key} shape {arr.shape} != expected "
                             f"{tuple(own[key].shape)}: channel config mismatch")
        own[key].copy_(torch.from_numpy(arr))


def make_gan_snapshot_fn(n_images: int):
    """``sample(g_ema, seed) -> (n, H, W, 3)`` uint8 EMA samples (z and the
    synthesis noise from ``seed``): the fakes grid of training snapshots,
    from the same seed each time so the grids stay comparable."""

    @torch.no_grad()
    def sample(g_ema, seed: int) -> torch.Tensor:
        device = next(g_ema.parameters()).device
        gen = torch.Generator(device=device).manual_seed(int(seed))
        z = torch.randn((n_images, g_ema.z_dim), device=device, generator=gen)
        img = g_ema(z, noise_mode="random", generator=gen)
        u8 = ((img.float() + 1.0) * 127.5).clamp(0.0, 255.0).to(torch.uint8)
        return u8.permute(0, 2, 3, 1)

    return sample


# --------------------------------- FID -------------------------------------- #


def make_gan_fid_fns(batch_size: int, mesh: Mesh | None = None):
    """The in-loop FID's two image sources, both ImageNet-normalized float
    NCHW, the domain the detectors take (``models/inception.py``):
    ``fake_images(g_ema, seed)`` samples ``batch_size`` images of the EMA
    generator (z and random synthesis noise from one generator seeded
    ``seed``, no truncation; a test may pass the latents ``z``),
    ``real_images(images_u8)`` converts a loader batch on its device. Both
    go through the same [0, 1] -> ImageNet normalization. With a ``mesh``
    a rank samples its rows of the batch's latents, with noise of its own
    (on a 2-D mesh, its data shard's: the ranks of a model group sample the
    same images, whole)."""
    from viscoin_tpu_torch.data.transforms import device_preprocess, normalize_only

    @torch.no_grad()
    def fake_images(g_ema, seed: int, z: torch.Tensor | None = None) -> torch.Tensor:
        device = next(g_ema.parameters()).device
        gen = torch.Generator(device=device).manual_seed(int(seed))
        if z is None:
            z = torch.randn((batch_size, g_ema.z_dim), device=device, generator=gen)
        if mesh is not None:
            z = z[mesh.rows(mesh.local(batch_size))]
            gen = torch.Generator(device=device).manual_seed(rank_seed(int(seed), mesh))
        img = g_ema(z, noise_mode="random", generator=gen)
        return normalize_only(((img.float() + 1.0) * 0.5).clamp(0.0, 1.0))

    @torch.no_grad()
    def real_images(images_u8: torch.Tensor) -> torch.Tensor:
        return device_preprocess(images_u8)

    return fake_images, real_images


def _features(detector, images: torch.Tensor, mesh: Mesh | None = None) -> np.ndarray:
    """The detector's features of ``images``, with a ``mesh`` those of the
    global batch (every data shard's rows, gathered in the data axis's rank
    order: on a 2-D mesh each image once)."""
    features = detector(images).detach()
    if mesh is not None:
        features = all_gather_batch(features.float(), mesh.data_axis)
    return features.double().cpu().numpy()


def accumulate_real_fid_stats(detector, real_images_fn, dataset, batch_size: int,
                              max_items: int, capture_all: bool = False, device="cuda",
                              mesh: Mesh | None = None):
    """The real side's FID moments: one pass in order over ``dataset``
    through ``real_images_fn`` and ``detector``, stopped at ``max_items``;
    a partial last batch is skipped, as in the JAX package. With a ``mesh``
    each data shard runs its shard of every batch."""
    from viscoin_tpu_torch.data.loader import DataLoader
    from viscoin_tpu_torch.eval.fid import FeatureStats

    shard = (0, 1) if mesh is None else (mesh.data_axis.rank, mesh.data_axis.world)
    rows = batch_size // shard[1]
    stats = FeatureStats(max_items=max_items, capture_all=capture_all)
    for images, _ in DataLoader(dataset, batch_size, shuffle=False, shard=shard):
        if images.shape[0] != rows:
            continue
        batch = torch.from_numpy(np.ascontiguousarray(images)).to(device)
        stats.append(_features(detector, real_images_fn(batch), mesh))
        if stats.num_items >= max_items:
            break
    return stats


def accumulate_fake_fid_stats(detector, fake_images_fn, g_ema, base_seed: int, max_items: int,
                              capture_all: bool = False, mesh: Mesh | None = None):
    """The fake side's FID moments: batch j sampled by ``fake_images_fn``
    with the seed ``fold_seed(base_seed, j)``, until ``max_items`` (the last
    batch's overshoot is cut). With a ``mesh`` each rank samples its rows of
    every batch (``make_gan_fid_fns(mesh=)``)."""
    from viscoin_tpu_torch.eval.fid import FeatureStats

    stats = FeatureStats(max_items=max_items, capture_all=capture_all)
    j = 0
    while stats.num_items < max_items:
        stats.append(_features(detector, fake_images_fn(g_ema, fold_seed(base_seed, j)), mesh))
        j += 1
    return stats


# ------------------------------- the draws ---------------------------------- #


@dataclass
class GANStepDraws:
    """The random numbers of one step. Tensors on the device: ``flips``
    (B,) bool, the latents (B, z_dim), ``pl_y`` (B, C, H, W) standard normal
    (path-length steps only). On the host: the style-mixing cutoffs (ints;
    ``num_ws`` = no mixing), the augmentation draws of the G pass, D's fake
    and real passes (None without augmentation), and the seeds of the
    synthesis noise of the G, D and PPL passes."""

    flips: torch.Tensor
    z: torch.Tensor
    z_mix: torch.Tensor
    z2: torch.Tensor
    z2_mix: torch.Tensor
    cutoff: int
    cutoff2: int
    aug_g: AugmentDraws | None
    aug_df: AugmentDraws | None
    aug_dr: AugmentDraws | None
    noise_seeds: dict
    zp: torch.Tensor | None = None
    pl_y: torch.Tensor | None = None

    def to(self, device) -> "GANStepDraws":
        """The same draws with the device tensors on ``device`` (the card
        against the CPU on the same numbers)."""
        moved = {k: (v.to(device) if isinstance(v, torch.Tensor) else v)
                 for k, v in self.__dict__.items()}
        return GANStepDraws(**moved)

    def shard(self, mesh: Mesh) -> "GANStepDraws":
        """A rank's draws: its data shard's rows of the global batch's
        per-image draws (the style-mixing cutoffs are the batch's), and
        synthesis noise seeds of its data shard's own; on a 2-D mesh
        ``pl_y``'s H rows are the rank's too."""
        rows = mesh.rows(mesh.local(self.z.shape[0]))
        out = {}
        for k, v in self.__dict__.items():
            if isinstance(v, torch.Tensor):
                v = v[rows]
            elif isinstance(v, AugmentDraws):
                v = v.rows(rows)
            out[k] = v
        axis = mesh.model_axis
        if axis is not None and self.pl_y is not None:
            out["pl_y"] = out["pl_y"][:, :, axis.rows(axis.local(self.pl_y.shape[2]))]
        out["noise_seeds"] = {k: rank_seed(v, mesh) for k, v in self.noise_seeds.items()}
        return GANStepDraws(**out)


def draw_step(cfg: GANTrainingParams, generator, seed: int, step: int, device,
              mesh: Mesh | None = None) -> GANStepDraws:
    """Step ``step``'s random numbers, a pure function of (seed, step):
    host draws from a CPU generator seeded ``fold_seed(seed, step)``, device
    draws from one seeded ``fold_seed(seed, step, DEVICE_TAG)``. With a
    ``mesh`` every rank draws the global batch's and keeps its own
    (:meth:`GANStepDraws.shard`)."""
    with tracing.span("gan_draw"):
        B, z_dim = cfg.batch_size, generator.z_dim
        num_ws = num_ws_for_resolution(generator.img_resolution)
        host = torch.Generator().manual_seed(fold_seed(seed, step))
        dev = torch.Generator(device=device).manual_seed(fold_seed(seed, step, _DEVICE_TAG))

        def cutoff() -> int:
            mix = float(torch.rand((), generator=host)) < cfg.style_mixing_prob
            k = int(torch.randint(1, num_ws, (), generator=host))
            return k if mix else num_ws

        def latents():
            return torch.randn((B, z_dim), device=device, generator=dev)

        use_aug = cfg.augment != "none"
        aug = [draw_augment(B, host) if use_aug else None for _ in range(3)]
        draws = GANStepDraws(
            flips=torch.rand(B, device=device, generator=dev) < 0.5, z=latents(), z_mix=latents(),
            z2=latents(), z2_mix=latents(), cutoff=cutoff(), cutoff2=cutoff(), aug_g=aug[0],
            aug_df=aug[1], aug_dr=aug[2],
            noise_seeds={k: fold_seed(seed, step, t) for k, t in _NOISE_TAGS.items()})
        if step % cfg.ppl_interval == 0 and cfg.ppl_weight > 0:
            res = generator.img_resolution
            draws.zp = latents()
            draws.pl_y = torch.randn((B, generator.synthesis.img_channels, res, res),
                                     device=device, generator=dev)
        return draws if mesh is None else draws.shard(mesh)


# ------------------------------ the losses ---------------------------------- #


def whole_ws_grads(partial: torch.Tensor, sp: S.Spatial | None) -> torch.Tensor:
    """The gradient of the whole path-length projection with respect to the
    latents (replicated over the model group) from this rank's part: the
    projection of its rows reaches the latents on every rank through the
    halo exchanges and the scatters, so the parts sum over the model group
    (differentiably, for the G update). ``partial`` itself without ``sp``."""
    return partial if sp is None else S.model_sum(partial, sp)


def _sub(params: dict, prefix: str) -> dict:
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


def make_gan_loss_fns(generator, discriminator, cfg: GANTrainingParams, mesh: Mesh | None = None):
    """The step's loss functions, factored out (as in JAX) so that tests can
    differentiate exactly what the step differentiates. Parameters are
    passed as {name: tensor} dicts of the modules' parameters (the fp32
    masters; they are cast to the compute dtype inside). With a ``mesh`` the
    batch statistics (mbstd, the path-length mean, r_t, the mean w) are the
    global batch's; the losses stay this data shard's means. On a 2-D mesh
    the images (``real``, ``pl_y``) are this rank's rows and the losses are
    whole on every rank of its model group.

    Returns a dict with ``g_loss_fn``, ``d_loss_fn``, ``ppl_penalty`` and
    the compute dtype ``dt``."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.compute_dtype]
    cast_groups = make_cast(cfg.compute_dtype)

    def cast(params: dict) -> dict:
        return cast_groups({"p": params})["p"]

    sp = S.gan_spatial(mesh, generator.img_resolution)

    if cfg.augment not in ("ada", "fixed", "none"):
        raise ValueError(f"augment={cfg.augment!r}: expected ada|fixed|none")
    use_aug = cfg.augment != "none"

    def map_ws(g_params, z):
        """(B, z_dim) -> (B, num_ws, w_dim) through the mapping network."""
        return functional_call(generator.mapping, _sub(g_params, "mapping."), (z,))

    def synth(g_params, ws, noise_seed: int):
        noise = torch.Generator(device=ws.device).manual_seed(int(noise_seed))
        return functional_call(generator.synthesis, _sub(g_params, "synthesis."), (ws,),
                               dict(noise_mode="random", generator=noise, spatial=sp))

    def run_d(d_params, images, aug_p, draws):
        """D with the ADA pipe in front (both real and fake batches)."""
        if use_aug:
            images = augment(images, aug_p, draws, sp=sp)
        return functional_call(discriminator, d_params, (images,),
                               {"mesh": mesh, "spatial": sp})

    def mixed_ws(g_params, z, z_mix, cutoff: int):
        """Style mixing: layers >= cutoff take the second latent's styles.
        Returns (mixed ws, the first latent's ws)."""
        ws = map_ws(g_params, z)
        if cutoff >= ws.shape[1]:
            return ws, ws
        ws_mix = map_ws(g_params, z_mix)
        return torch.cat([ws[:, :cutoff], ws_mix[:, cutoff:]], dim=1), ws

    def g_loss_fn(g_params, d_params, z, z_mix, cutoff, noise_seed, aug_p, aug_draws):
        g_params, d_params = cast(g_params), cast(d_params)
        ws_used, ws = mixed_ws(g_params, z, z_mix, cutoff)
        fake = synth(g_params, ws_used, noise_seed)
        logits = run_d(d_params, fake.to(dt), aug_p, aug_draws).float()
        # The non-saturating G loss; aux: the batch mean of w for w_avg.
        return F.softplus(-logits).mean(), all_mean(ws[:, 0].detach().float().mean(dim=0), mesh)

    def ppl_penalty(g_params, z, noise_seed, pl_y, pl_mean):
        """Path-length regularisation: (||d(img . y)/d ws|| - pl_mean)^2,
        differentiated again by the G update. ``new_pl_mean`` is not
        detached in the penalty (NVlabs), so the gradient keeps the
        -2 * decay / B cross term."""
        g_params = cast(g_params)
        ws = map_ws(g_params, z)
        img = synth(g_params, ws, noise_seed)
        h, w = img.shape[2] * (1 if sp is None else sp.model), img.shape[3]
        proj = (img.float() * (pl_y / math.sqrt(h * w))).sum()  # this rank's rows' part
        (pl_grads,) = torch.autograd.grad(proj, ws, create_graph=True)
        pl_grads = whole_ws_grads(pl_grads, sp)
        pl_lengths = pl_grads.float().square().sum(dim=2).mean(dim=1).sqrt()
        batch_mean = all_mean(pl_lengths.mean(), mesh)  # not detached: the global mean
        new_pl_mean = pl_mean + cfg.ppl_decay * (batch_mean - pl_mean)
        penalty = (pl_lengths - new_pl_mean).square().mean()
        return penalty * cfg.ppl_weight * cfg.ppl_interval, (batch_mean, new_pl_mean)

    def d_loss_fn(d_params, g_params, real, z, z_mix, cutoff, noise_seed, do_r1: bool, aug_p,
                  aug_draws_f, aug_draws_r):
        d_params = cast(d_params)
        with torch.no_grad():  # the fakes need no gradient: D's loss is taken for D
            g_params = cast({k: v.detach() for k, v in g_params.items()})
            ws_used, _ = mixed_ws(g_params, z, z_mix, cutoff)
            fake = synth(g_params, ws_used, noise_seed).to(dt)
        fake_logits = run_d(d_params, fake, aug_p, aug_draws_f).float()
        real = real.detach().requires_grad_(do_r1)
        real_logits = run_d(d_params, real, aug_p, aug_draws_r).float()
        loss = F.softplus(fake_logits).mean() + F.softplus(-real_logits).mean()
        r1 = torch.zeros((), device=real.device)
        if do_r1:
            # Through the same augmentation draws as the real pass (whose
            # logits these are): the lazy R1 penalty, second order.
            with tracing.span("gan_step.r1"):
                (grad_real,) = torch.autograd.grad(real_logits.sum(), real, create_graph=True)
                norms = grad_real.float().square().sum(dim=(1, 2, 3))
                if sp is not None:
                    # The logits are whole on every rank: its rows' gradient is
                    # ``model`` times theirs; the squared norm sums over the rows.
                    norms = S.model_sum(norms, sp) / sp.model**2
                r1 = norms.mean()
                loss = loss + (cfg.r1_gamma / 2) * r1 * cfg.r1_interval
        # aux: r_t, the ADA overfitting signal E[sign(D(real))] (global).
        return loss, (r1.detach(), all_mean(torch.sign(real_logits.detach()).mean(), mesh))

    return {"g_loss_fn": g_loss_fn, "d_loss_fn": d_loss_fn, "ppl_penalty": ppl_penalty,
            "dt": dt}


# ------------------------------- the step ----------------------------------- #


def preprocess_real(images_u8: torch.Tensor, flips: torch.Tensor | None) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, C, H, W) float in [-1, 1], x-flipped where
    ``flips``."""
    x = images_u8.permute(0, 3, 1, 2).float() / 127.5 - 1.0
    if flips is not None:
        x = torch.where(flips[:, None, None, None], x.flip(3), x)
    return x


def _grads(loss, params: list) -> list:
    return list(torch.autograd.grad(loss, params, materialize_grads=True))


@torch.no_grad()
def _adam_step(opt: torch.optim.Adam, params: list, grads: list) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None


def ema_beta(cfg: GANTrainingParams, step: int, batch: int) -> float:
    """The generator EMA's beta at ``step`` (fp32, as JAX computes it)."""
    nimg = np.float32(cfg.ema_kimg * 1000.0)
    if cfg.ema_rampup > 0:
        nimg = min(nimg, np.float32((np.float32(step) + np.float32(1.0)) * np.float32(batch))
                   * np.float32(cfg.ema_rampup))
    return float(np.float32(0.5) ** (np.float32(batch) / max(np.float32(nimg),
                                                             np.float32(1e-8))))


def _reduced(grads: list, mesh: Mesh | None) -> list:
    return grads if mesh is None else all_reduce_grads(grads, mesh)


def make_gan_train_step(generator, discriminator, cfg: GANTrainingParams,
                        mesh: Mesh | None = None):
    """One alternating G/D step with style mixing, lazy R1 and PPL, w_avg
    tracking, the generator EMA and ADA.

    Returns ``step(state, images, draws) -> (state, metrics)``: ``images``
    (B, H, W, C) uint8 on the device, ``draws`` from :func:`draw_step` for
    ``state.step``. The state is updated in place and returned; the metrics
    are 0-d device tensors (r1 and pl_lengths 0 off their cadence). With a
    data-parallel ``mesh`` the images and draws are this rank's slice of the
    global batch, each update takes the gradients' mean over the ranks, and
    the metrics are global. On a 2-D mesh the images are also this rank's
    rows along H (the draws' ``pl_y`` too, :meth:`GANStepDraws.shard`)."""
    fns = make_gan_loss_fns(generator, discriminator, cfg, mesh)
    g_loss_fn, d_loss_fn, ppl_penalty = fns["g_loss_fn"], fns["d_loss_fn"], fns["ppl_penalty"]
    dt = fns["dt"]

    def step(state: GANTrainState, images, draws: GANStepDraws):
        with tracing.span("gan_step"):
            i = state.step
            x = preprocess_real(images, draws.flips if cfg.mirror else None).to(dt)
            B = x.shape[0] * (1 if mesh is None else mesh.data_axis.world)  # the global batch
            aug_p = float(state.ada_p) if cfg.augment == "ada" else cfg.augment_p
            g_named, d_named = state.g_params(), state.d_params()
            g_list, d_list = list(g_named.values()), list(d_named.values())

            # The G phase (style mixing), plus the path-length penalty on cadence.
            with tracing.span("gan_step.g_forward"):
                d_frozen = {k: v.detach() for k, v in d_named.items()}
                g_loss, ws_mean = g_loss_fn(g_named, d_frozen, draws.z.to(dt),
                                            draws.z_mix.to(dt), draws.cutoff,
                                            draws.noise_seeds["g"], aug_p, draws.aug_g)
            with tracing.span("gan_step.g_backward"):
                g_grads = _grads(g_loss, g_list)
            pl_len, new_pl_mean = torch.zeros((), device=x.device), state.pl_mean
            if i % cfg.ppl_interval == 0 and cfg.ppl_weight > 0:
                with tracing.span("gan_step.path_length"):
                    scaled, (pl_len, new_pl_mean) = ppl_penalty(
                        g_named, draws.zp.to(dt), draws.noise_seeds["ppl"], draws.pl_y,
                        state.pl_mean)
                    g_grads = [a + b for a, b in zip(g_grads, _grads(scaled, g_list))]
                    pl_len, new_pl_mean = pl_len.detach(), new_pl_mean.detach()
            with tracing.span("gan_step.g_update"):
                _adam_step(state.g_opt, g_list, _reduced(g_grads, mesh))

            # The D phase, against the updated generator, with R1 on cadence.
            with tracing.span("gan_step.d_forward"):
                d_loss, (r1, rt_batch) = d_loss_fn(
                    d_named, g_named, x, draws.z2.to(dt), draws.z2_mix.to(dt), draws.cutoff2,
                    draws.noise_seeds["d"], i % cfg.r1_interval == 0, aug_p, draws.aug_df,
                    draws.aug_dr)
            with tracing.span("gan_step.d_backward"):
                d_grads = _grads(d_loss, d_list)
            with tracing.span("gan_step.d_update"):
                # Each list goes once used: the unreduced one when reduced, the reduced one
                # after the update (the step's peak memory holds neither longer).
                d_grads = _reduced(d_grads, mesh)
                _adam_step(state.d_opt, d_list, d_grads)
                del d_grads

            with torch.no_grad(), tracing.span("gan_step.ema_ada"):
                if cfg.augment == "ada":
                    state.ada_p, state.ada_rt = ada_update(
                        state.ada_p, state.ada_rt, rt_batch, i, B, target=cfg.ada_target,
                        interval=cfg.ada_interval, kimg=cfg.ada_kimg)
                state.w_avg = (ws_mean.detach() * (1 - cfg.w_avg_beta)
                               + state.w_avg * cfg.w_avg_beta)
                beta = ema_beta(cfg, i, B)
                ema = list(state.g_ema.parameters())
                torch._foreach_mul_(ema, beta)
                torch._foreach_add_(ema, g_list,
                                    alpha=float(np.float32(1.0) - np.float32(beta)))
                state.pl_mean = new_pl_mean
            state.step = i + 1
            losses = torch.stack([g_loss.detach(), d_loss.detach(), r1])
            if mesh is not None:
                losses = all_mean(losses, mesh)
            metrics = {"g_loss": losses[0], "d_loss": losses[1], "r1": losses[2],
                       "pl_lengths": pl_len, "pl_mean": new_pl_mean,
                       "ada_p": state.ada_p.clone(), "ada_rt": rt_batch}
            return state, metrics

    return step
