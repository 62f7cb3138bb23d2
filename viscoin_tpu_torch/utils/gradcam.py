"""GradCAM over the concept extractor Psi.

Counterpart of ``viscoin_tpu/utils/gradcam.py``. The heatmap of a layer is

    heatmap(A, dL/dA) = relu( sum_c mean_hw(dL/dA)_c * A_c ), min-max normalized

per image, a constant map going to 0. A is the pre-ReLU output of one of
Psi's five convolutions and L the explainer's mean cross-entropy. As in the
JAX package, dL/dA is the gradient with respect to a zero perturbation added
to that output (``ConceptExtractor.forward_taps``), not a hook: the
gradients are taken for the five perturbations only, so no parameter
gradient is computed, and the classifier runs without a graph. The backward
runs under cuDNN's deterministic algorithms, so one batch gives the same
maps in every call on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from viscoin_tpu_torch.utils import cudnn

CONVS = tuple(f"conv{i}" for i in range(1, 6))


def gradcam_heatmap(activation: torch.Tensor, gradient: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) activation and dL/dA of the same shape -> (B, H, W)
    fp32 heatmaps in [0, 1]."""
    a, g = activation.float(), gradient.float()
    weights = g.mean(dim=(2, 3))  # (B, C)
    maps = torch.relu((a * weights[:, :, None, None]).sum(dim=1))  # (B, H, W)
    mn = maps.amin(dim=(1, 2), keepdim=True)
    mx = maps.amax(dim=(1, 2), keepdim=True)
    rng = mx - mn
    return (maps - mn) / torch.where(rng == 0, torch.ones_like(rng), rng)


def psi_gradcams(models, latents, labels: torch.Tensor | None = None):
    """The heatmaps of conv1..conv5 for the explainer's cross-entropy at
    ``labels``, or at the explainer's own prediction when None (what
    serving explains). ``latents``: the classifier's hidden_states[-3:].

    Returns ({conv name: (B, h, w) fp32 tensor}, Phi, explainer logits)."""
    psi = models.concept_extractor
    latents = tuple(t.detach() for t in latents)
    with torch.enable_grad(), cudnn.deterministic_cudnn():
        eps = [torch.zeros(s, device=latents[0].device, dtype=latents[0].dtype,
                           requires_grad=True) for s in psi.tap_shapes(latents)]
        phi, _, acts = psi.forward_taps(latents, eps)
        logits = models.explainer(phi).float()
        if labels is None:
            labels = logits.detach().argmax(dim=-1)
        loss = F.cross_entropy(logits, labels.long())
        grads = torch.autograd.grad(loss, eps)
    heatmaps = {name: gradcam_heatmap(a.detach(), g) for name, a, g in zip(CONVS, acts, grads)}
    return heatmaps, phi.detach(), logits.detach()


def concept_extractor_gradcams(models, images: torch.Tensor | None = None,
                               labels: torch.Tensor | None = None, latents=None):
    """GradCAM heatmaps of Psi's conv1..conv5 for the explainer's
    cross-entropy at ``labels`` (the ``concept-heatmaps`` command).

    Either ``images`` (preprocessed NCHW, run through the classifier without
    a graph) or ``latents`` (the classifier's hidden_states[-3:]) must be
    given.

    Returns ({conv name: (B, h, w) numpy}, explainer logits numpy)."""
    if latents is None:
        with torch.no_grad():
            _, hidden = models.classifier(images)
        latents = hidden[-3:]
    heatmaps, _, logits = psi_gradcams(models, latents, labels)
    return {name: m.cpu().numpy() for name, m in heatmaps.items()}, logits.cpu().numpy()
