"""Loss functions of the VisCoIN ensemble.

Counterpart of ``viscoin_tpu/train/losses.py``, function for function, with
``.detach()`` where JAX has ``stop_gradient``. Concept tensors are NCHW:
Phi is (B, K, 3, 3). The LPIPS network is passed in as a callable.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from viscoin_tpu_torch.models.concept_extractor import max_pool_concepts
from viscoin_tpu_torch.parallel.spatial import model_sum


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)


def entropy_loss(v: torch.Tensor) -> torch.Tensor:
    """-sum p log p over softmax rows (a sum over all elements, not a mean)."""
    p = torch.softmax(v, dim=1)
    return -torch.sum(p * torch.log(p + 1e-30))


def cross_cross_entropy_loss(prediction: torch.Tensor,
                             target_prediction: torch.Tensor) -> torch.Tensor:
    """Soft-label cross-entropy between two logit tensors."""
    logp = F.log_softmax(prediction, dim=1)
    t = torch.softmax(target_prediction, dim=1)
    return torch.mean(torch.sum(-t * logp, dim=1))


def l1_loss(x: torch.Tensor) -> torch.Tensor:
    """Mean absolute value."""
    return torch.mean(torch.abs(x))


def conciseness_diversity_loss(phi: torch.Tensor, eta: float = 1.0) -> torch.Tensor:
    """FLINT's conciseness / diversity loss (kept for parity, unused by VisCoIN)."""
    pooled = max_pool_concepts(phi)
    return (-entropy_loss(pooled.mean(dim=0, keepdim=True)) + entropy_loss(pooled)
            + eta * l1_loss(pooled))


def concept_regularization_loss(phi: torch.Tensor) -> torch.Tensor:
    """Sparsity: L1 of the L2-normalised max-pooled concepts + L1 of Phi."""
    return l1_loss(_unit_rows(max_pool_concepts(phi))) + l1_loss(phi)


def concept_orthogonality_loss(conv5_weight: torch.Tensor) -> torch.Tensor:
    """Orthogonality of the concept dictionary: the concept extractor's conv5
    weight, OIHW (n_concepts, 3 * latent_channels, 1, 1), viewed as
    (n_concepts, -1)."""
    n = conv5_weight.shape[0]
    w = torch.abs(_unit_rows(conv5_weight.reshape(n, -1)))
    return (torch.sum(w @ w.T) - n) / (n**2)


def reconstruction_loss(reconstructed, original, reconstructed_classes, original_classes,
                        lpips_fn, lambda_classes: float = 0.1,
                        lambda_lpips: float = 3.0, spatial=None) -> torch.Tensor:
    """L1 + MSE + lambda_lpips * LPIPS + lambda_classes * cross-CE(f(x^),
    detached f(x)). ``lpips_fn(x, y)`` -> (B,) or scalar distances.
    ``spatial`` (``parallel/spatial.py``): the images are this rank's rows
    of H-sharded batches, and the pixel means those of the whole images (the
    classes and the distances are whole already)."""
    diff = reconstructed - original
    if spatial is None:
        loss = torch.mean(torch.abs(diff)) + torch.mean(torch.square(diff))
    else:
        sums = model_sum(torch.stack([diff.abs().sum(), diff.square().sum()]), spatial)
        loss = (sums[0] + sums[1]) / (diff.numel() * spatial.model)
    loss = loss + lambda_classes * cross_cross_entropy_loss(reconstructed_classes,
                                                            original_classes.detach())
    return loss + lambda_lpips * torch.mean(lpips_fn(reconstructed, original))


def output_fidelity_loss(original_classes: torch.Tensor,
                         explainer_classes: torch.Tensor) -> torch.Tensor:
    """cross-CE(Theta(Psi) logits, detached f logits)."""
    return cross_cross_entropy_loss(explainer_classes, original_classes.detach())


def gan_regularization_loss(gan_latents: torch.Tensor, fixed_w_avg: torch.Tensor) -> torch.Tensor:
    """MSE between the style vectors and the detached ``fixed_w_avg``."""
    target = fixed_w_avg.detach()[None, None, :].expand_as(gan_latents)
    return torch.mean(torch.square(gan_latents - target))


def info_nce(query, positive_key, negative_keys=None, temperature: float = 0.1,
             negative_mode: str = "unpaired") -> torch.Tensor:
    """InfoNCE contrastive loss (not on any VisCoIN training path)."""
    query, positive_key = _unit_rows(query), _unit_rows(positive_key)
    if negative_keys is not None:
        negative_keys = _unit_rows(negative_keys)
        positive_logit = torch.sum(query * positive_key, dim=1, keepdim=True)
        if negative_mode == "unpaired":
            negative_logits = query @ negative_keys.T
        else:  # paired: (N, M, D)
            negative_logits = torch.einsum("nd,nmd->nm", query, negative_keys)
        logits = torch.cat([positive_logit, negative_logits], dim=1)
        labels = torch.zeros(logits.shape[0], dtype=torch.long, device=logits.device)
    else:
        logits = query @ positive_key.T
        labels = torch.arange(query.shape[0], device=query.device)
    logp = F.log_softmax(logits / temperature, dim=1)
    return -torch.mean(torch.gather(logp, 1, labels[:, None]))


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy with integer labels, mean-reduced."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels.long()[:, None]))
