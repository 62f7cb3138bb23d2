"""PPL: the perceptual path length of a generator.

Counterpart of ``viscoin_tpu/eval/ppl.py`` (stylegan2-ada's ``ppl2_wend``
analogue). Per segment: endpoints w0, w1 = mapping(z0), mapping(z1), no
truncation; ``sampling="end"`` (the default, the published ppl2_wend) takes
t = 0, ``"full"`` draws t ~ U(0, 1); wt0 = lerp(w0, w1, t), wt1 = lerp(w0,
w1, t + epsilon); both go through ONE synthesis batch of 2B with const noise,
pooled to 256² above that; distance = lpips(img_t0, img_t1) / epsilon². The
PPL is the mean over the distances within [p1, p99] (``np.percentile`` with
``method="lower"`` and ``"higher"``, float64).

The two images differ by about epsilon times the image's scale, so the
distance is a small difference of nearly equal features:
  * it is taken in LPIPS's own normalized-difference form
    (``LPIPS.normalized_difference``), not the one-pass form of the JAX
    package's LPIPS, whose fp32 sums cancel to rounding at epsilon = 1e-4
    (ROADMAP.md §3);
  * TF32 (a 10-bit mantissa) rounds more than that difference, so synthesis
    and distance run with ``cudnn.allow_tf32`` and ``cuda.matmul.allow_tf32``
    off (:func:`no_tf32`; the caller's settings come back afterwards), as
    upstream turns TF32 off.

Random numbers: batch j's draws (z0, z1, t) come from a CPU
``torch.Generator`` seeded ``fold_seed(seed, j)`` (:func:`ppl_draws`), so
the card and the CPU measure the same segments; the streams differ from
JAX's by design (PARITY.md, divergence 7) and tests inject JAX's.

Two distance routes: this package's LPIPS-VGG (values comparable between
generators measured here), or :func:`compute_ppl_torchscript` with the NVlabs
``vgg16.pt`` TorchScript network, run on the device with upstream's scaling
((img + 1) * 255 / 2, ``resize_images=False, return_lpips=True``, squared L2
of the embeddings): numerically upstream's distance.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class PPLDraws(NamedTuple):
    """One batch's random numbers: z0, z1 (B, z_dim) and t (B,)."""

    z0: torch.Tensor
    z1: torch.Tensor
    t: torch.Tensor


def ppl_draws(seed: int, j: int, batch_size: int, z_dim: int, sampling: str = "end") -> PPLDraws:
    """Batch ``j``'s draws on the CPU. t is drawn in both modes (and zeroed
    for "end"), so the endpoints are the same in both."""
    from viscoin_tpu_torch.train.viscoin import fold_seed

    if sampling not in ("end", "full"):
        raise ValueError(f"sampling must be 'end' or 'full', got {sampling!r}")
    gen = torch.Generator().manual_seed(fold_seed(seed, j))
    z0 = torch.randn((batch_size, z_dim), generator=gen)
    z1 = torch.randn((batch_size, z_dim), generator=gen)
    t = torch.rand((batch_size,), generator=gen)
    return PPLDraws(z0, z1, t if sampling == "full" else torch.zeros_like(t))


@contextlib.contextmanager
def no_tf32():
    """cuDNN's and cuBLAS's TF32 off inside, the caller's settings after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def pool256(img: torch.Tensor) -> torch.Tensor:
    """NCHW images above 256² average-pooled to 256² (upstream's
    convention for the perceptual distance)."""
    if img.shape[2] <= 256:
        return img
    return F.avg_pool2d(img, img.shape[2] // 256)


@torch.no_grad()
def path_pair_images(generator, draws: PPLDraws, epsilon: float) -> torch.Tensor:
    """The pair images of both routes: (2B, C, H, W), the B images at t,
    then the B at t + epsilon, pooled to 256² above it."""
    device = next(generator.parameters()).device
    z0, z1, t = (x.to(device) for x in draws)
    w0, w1 = generator.mapping(z0), generator.mapping(z1)
    t = t[:, None, None]
    wt0 = w0 + (w1 - w0) * t
    wt1 = w0 + (w1 - w0) * (t + epsilon)
    img = generator.synthesis(torch.cat([wt0, wt1]), noise_mode="const")
    return pool256(img)


def make_ppl_sampler(generator, lpips, epsilon: float = 1e-4):
    """``sample(draws) -> (B,)`` distances on the device: pair synthesis,
    LPIPS / epsilon², TF32 off."""

    @torch.no_grad()
    def sample(draws: PPLDraws) -> torch.Tensor:
        with no_tf32():
            img = path_pair_images(generator, draws, epsilon)
            b = img.shape[0] // 2
            return lpips.normalized_difference(img[:b], img[b:]).float() / (epsilon * epsilon)

    return sample


@torch.no_grad()
def torchscript_pair_distances(module, img: torch.Tensor, epsilon: float) -> np.ndarray:
    """Upstream's distance of a (2B, C, H, W) pair batch through the NVlabs
    ``vgg16.pt`` module (on the images' device): grayscale repeated to 3
    channels, (img + 1) * 255 / 2, the squared L2 between the pair's
    embeddings / epsilon², as float64."""
    if img.shape[1] == 1:
        img = img.repeat(1, 3, 1, 1)
    x = (img.float() + 1.0) * (255.0 / 2.0)
    feats = module(x, resize_images=False, return_lpips=True)
    f0, f1 = feats.chunk(2)
    d = (f0 - f1).square().sum(dim=1) / (epsilon * epsilon)
    return d.cpu().numpy().astype(np.float64)


def ppl_from_distances(dists) -> float:
    """The mean over the [p1, p99] distances, in float64."""
    dists = np.asarray(dists, np.float64)
    lo = np.percentile(dists, 1, method="lower")
    hi = np.percentile(dists, 99, method="higher")
    return float(dists[(dists >= lo) & (dists <= hi)].mean())


def compute_ppl(generator, lpips, n_samples: int, batch_size: int, seed: int = 0,
                epsilon: float = 1e-4, sampling: str = "end") -> float:
    """PPL over ``n_samples`` segments (``ceil(n / batch_size)`` batches of
    :func:`ppl_draws`), through LPIPS on the generator's device."""
    sample = make_ppl_sampler(generator, lpips, epsilon)
    out = [sample(ppl_draws(seed, j, batch_size, generator.z_dim, sampling)).double().cpu()
           for j in range(math.ceil(n_samples / batch_size))]
    return ppl_from_distances(torch.cat(out).numpy()[:n_samples])


def compute_ppl_torchscript(generator, ts_path: str, n_samples: int, batch_size: int,
                            seed: int = 0, epsilon: float = 1e-4, sampling: str = "end") -> float:
    """PPL with the distance through the NVlabs ``vgg16.pt`` TorchScript
    network on the generator's device; the same draws as
    :func:`compute_ppl`, so both routes measure the same segments."""
    device = next(generator.parameters()).device
    module = torch.jit.load(ts_path, map_location=device).eval()
    out = []
    with no_tf32():
        for j in range(math.ceil(n_samples / batch_size)):
            img = path_pair_images(generator, ppl_draws(seed, j, batch_size, generator.z_dim,
                                                        sampling), epsilon)
            out.append(torchscript_pair_distances(module, img, epsilon))
    return ppl_from_distances(np.concatenate(out)[:n_samples])
