"""Latent projection: invert a target image into the generator's W space.

Counterpart of ``viscoin_tpu/eval/projection.py`` (stylegan2-ada's
``projector.py`` semantics as the JAX module keeps them): w starts at w_avg,
estimated from ``w_avg_samples`` mapped z draws; each step probes w plus
annealed exploration noise (``initial_noise_factor`` times w's spread, a
quadratic ramp to 0 over the first ``noise_ramp_length`` of the steps); the
learning rate ramps up linearly over the first ``lr_rampup_length`` and down
on a cosine over the last ``lr_rampdown_length``; Adam as
``optax.scale_by_adam`` (β 0.9 / 0.999, eps 1e-8, bias-corrected), then
``p -= lr * update``. With ``optimize_noise`` the synthesis noise buffers are
optimised with w: they start as fresh N(0, 1) draws, the loss adds
``regularize_noise_weight`` times their multi-scale autocorrelation
(:func:`noise_regularization`), and after each step they are renormalised to
zero mean and unit RMS (:func:`_normalize_noise`). Without it they stay the
generator's. Images above 256² are average-pooled to 256² before the LPIPS
distance. ``w_plus`` optimises one w per style layer.

The generator is frozen. The noise buffers enter the synthesis as leaf
tensors through ``torch.func.functional_call``, so autograd computes the
gradients of w and the buffers only: ``bias_act``'s backward runs its
kernel without the bias-gradient kernel, and ``upfirdn2d``'s backward its
adjoint, at batch 1. JAX runs the steps as one ``lax.scan``; here each step
is a Python iteration (no CUDA graphs).

Random numbers: the w_avg latents, the initial noise buffers and every
step's exploration noise are drawn before the loop, in one
:class:`ProjectionDraws` (:func:`draw_projection`, a CPU generator seeded
``seed``), so tests can give it JAX's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch.func import functional_call

from viscoin_tpu_torch.eval.ppl import pool256


def noise_regularization(noise: torch.Tensor) -> torch.Tensor:
    """Upstream's multi-scale autocorrelation penalty of ONE (res, res)
    buffer: at every scale (2x average-pooled down to 8²), mean(n * roll(n,
    1, x))² + mean(n * roll(n, 1, y))²."""
    n = noise.float()
    reg = torch.zeros((), device=n.device)
    while True:
        reg = reg + (n * torch.roll(n, 1, dims=1)).mean().square()
        reg = reg + (n * torch.roll(n, 1, dims=0)).mean().square()
        if n.shape[0] <= 8:
            break
        h = n.shape[0] // 2
        n = n.reshape(h, 2, h, 2).mean(dim=(1, 3))
    return reg


def _normalize_noise(noise: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Each buffer to zero mean and unit RMS (upstream's per-step
    renormalisation)."""
    out = {}
    for k, n in noise.items():
        n = n - n.mean()
        out[k] = n * torch.rsqrt(n.square().mean() + 1e-20)
    return out


def noise_buffer_names(generator) -> list[str]:
    """The synthesis network's ``noise_const`` buffers, by their names under
    ``generator.synthesis``."""
    return [k for k, _ in generator.synthesis.named_buffers() if k.endswith("noise_const")]


@dataclass
class ProjectionDraws:
    """The random numbers of one projection: ``z`` (w_avg_samples, z_dim),
    the initial ``noise`` buffers {name: (res, res)}, and ``steps``
    (num_steps, rows, w_dim) standard normal exploration noise, rows = the
    style layers with ``w_plus``, else 1."""

    z: torch.Tensor
    noise: dict[str, torch.Tensor]
    steps: torch.Tensor

    def to(self, device) -> "ProjectionDraws":
        return ProjectionDraws(self.z.to(device), {k: v.to(device) for k, v in self.noise.items()},
                               self.steps.to(device))


def draw_projection(generator, num_steps: int, w_plus: bool = False, w_avg_samples: int = 2048,
                    seed: int = 0) -> ProjectionDraws:
    """Every random number of a projection, from a CPU generator seeded
    ``seed`` (the same on every device)."""
    gen = torch.Generator().manual_seed(int(seed))
    z = torch.randn((w_avg_samples, generator.z_dim), generator=gen)
    noise = {k: torch.randn(tuple(generator.synthesis.get_buffer(k).shape), generator=gen)
             for k in noise_buffer_names(generator)}
    rows = generator.synthesis.num_ws if w_plus else 1
    steps = torch.randn((num_steps, rows, generator.w_dim), generator=gen)
    return ProjectionDraws(z, noise, steps)


def projection_loss(generator, lpips, w: torch.Tensor, noise: dict[str, torch.Tensor],
                    target: torch.Tensor, optimize_noise: bool = True,
                    regularize_noise_weight: float = 1e5):
    """(loss, LPIPS distance) of ``w`` (1 or num_ws rows, w_dim) with the
    noise buffers ``noise`` against ``target`` (1, C, 256 or less, same);
    the loss adds the buffers' penalty when ``optimize_noise``."""
    ws = w.expand(generator.synthesis.num_ws, -1) if w.shape[0] == 1 else w
    img = functional_call(generator.synthesis, noise, (ws[None],), dict(noise_mode="const"))
    dist = lpips(pool256(img), target).sum()
    if not optimize_noise:
        return dist, dist
    reg = sum(noise_regularization(n) for n in noise.values())
    return dist + regularize_noise_weight * reg, dist


def make_projector(generator, lpips, num_steps: int = 1000, w_plus: bool = False,
                   learning_rate: float = 0.1, initial_noise_factor: float = 0.05,
                   noise_ramp_length: float = 0.75, lr_rampdown_length: float = 0.25,
                   lr_rampup_length: float = 0.05, optimize_noise: bool = True,
                   regularize_noise_weight: float = 1e5):
    """Returns ``project(target, draws, on_step=None) -> (w, noise,
    losses)``: ``target`` (1, C, H, W) in [-1, 1] on the generator's device,
    ``draws`` from :func:`draw_projection` (on that device); ``w`` comes
    back as (num_ws, w_dim) (one w broadcast, or per layer with
    ``w_plus``), ``noise`` as {buffer name: (res, res)} (the generator's own
    without ``optimize_noise``), ``losses`` (num_steps,) the LPIPS distances.
    ``on_step(i, grads)``, if given, is called after step i with that
    step's gradients ([w, *the noise buffers] or [w]), for timing and
    checks."""
    num_ws = generator.synthesis.num_ws
    synthesis = generator.synthesis
    beta1, beta2, eps = 0.9, 0.999, 1e-8

    def lr_at(t: float) -> float:
        ramp = min(1.0, (1.0 - t) / lr_rampdown_length)
        ramp = 0.5 - 0.5 * math.cos(ramp * math.pi)
        return learning_rate * ramp * min(1.0, t / lr_rampup_length)

    def project(target: torch.Tensor, draws: ProjectionDraws,
                on_step: Callable[[int, list], None] | None = None):
        target = pool256(target)
        with torch.no_grad():
            w_samples = generator.mapping(draws.z)[:, 0]
            w_avg = w_samples.mean(dim=0)
            w_std = float((w_samples - w_avg).square().sum(dim=1).mean().sqrt())
        w = w_avg.expand(num_ws if w_plus else 1, -1).clone()
        if optimize_noise:
            noise = {k: v.clone() for k, v in draws.noise.items()}
        else:
            noise = {k: synthesis.get_buffer(k) for k in noise_buffer_names(generator)}
        params = [w, *noise.values()] if optimize_noise else [w]
        m = [torch.zeros_like(p) for p in params]
        v = [torch.zeros_like(p) for p in params]
        losses = []
        for i in range(num_steps):
            t = i / num_steps
            scale = w_std * initial_noise_factor * max(0.0, 1.0 - t / noise_ramp_length) ** 2
            w_noised = (w + draws.steps[i] * scale).requires_grad_(True)
            leaves = {k: n.requires_grad_(True) for k, n in noise.items()} if optimize_noise \
                else noise
            loss, dist = projection_loss(generator, lpips, w_noised, leaves, target,
                                         optimize_noise, regularize_noise_weight)
            grads = torch.autograd.grad(
                loss, [w_noised, *leaves.values()] if optimize_noise else [w_noised])
            with torch.no_grad():
                lr = lr_at(t)
                c1, c2 = 1.0 - beta1 ** (i + 1), 1.0 - beta2 ** (i + 1)
                new = []
                for p, g, mi, vi in zip(params, grads, m, v):
                    mi.mul_(beta1).add_(g, alpha=1.0 - beta1)
                    vi.mul_(beta2).addcmul_(g, g, value=1.0 - beta2)
                    new.append(p - lr * ((mi / c1) / ((vi / c2).sqrt() + eps)))
                w = new[0]
                if optimize_noise:
                    noise = _normalize_noise(dict(zip(noise, new[1:])))
                params = [w, *noise.values()] if optimize_noise else [w]
            losses.append(dist.detach())
            if on_step is not None:
                on_step(i, grads)
        w_final = w if w_plus else w.expand(num_ws, -1)
        return w_final.detach(), {k: n.detach() for k, n in noise.items()}, torch.stack(losses)

    return project


@torch.no_grad()
def render(generator, w: torch.Tensor, noise: dict[str, torch.Tensor]) -> torch.Tensor:
    """(num_ws, w_dim) and noise buffers -> the (1, C, H, W) image."""
    return functional_call(generator.synthesis, noise, (w[None],), dict(noise_mode="const"))


def project_image(generator, lpips, target_m11: np.ndarray, num_steps: int = 1000,
                  w_plus: bool = False, seed: int = 0, w_avg_samples: int = 2048, **kwargs):
    """Project one (H, W, C) image in [-1, 1]; returns (w (num_ws, w_dim),
    losses (num_steps,), the final render as (H, W, C) uint8), all numpy.
    The render uses the optimised noise buffers."""
    from viscoin_tpu_torch.cli.generate import to_u8

    device = next(generator.parameters()).device
    project = make_projector(generator, lpips, num_steps=num_steps, w_plus=w_plus, **kwargs)
    target = torch.from_numpy(np.ascontiguousarray(target_m11.transpose(2, 0, 1)))[None]
    draws = draw_projection(generator, num_steps, w_plus, w_avg_samples, seed).to(device)
    w, noise, losses = project(target.to(device), draws)
    return (w.cpu().numpy(), losses.cpu().numpy(),
            to_u8(render(generator, w, noise))[0].numpy())
