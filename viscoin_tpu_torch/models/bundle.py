"""VisCoINModels: the four models of the ensemble as one ``nn.Module``.

Counterpart of ``viscoin_tpu/models/bundle.py``: classifier f, concept
extractor Psi, explainer Theta and the adapted generator, with
``forward_all`` as the canonical VisCoIN pass (f -> Psi -> Theta, and
G(Phi, Phi') -> reconstruction). Weights start random from a seed
(:func:`init_models`) or come from the JAX package through
``utils/weights.py::load_jax_variables``.
"""

from __future__ import annotations

import torch
from torch import nn

from viscoin_tpu_torch.models.concept_extractor import ConceptExtractor
from viscoin_tpu_torch.models.explainer import Explainer
from viscoin_tpu_torch.models.resnet import Classifier
from viscoin_tpu_torch.models.stylegan import GeneratorAdapted


class VisCoINModels(nn.Module):
    def __init__(self, classifier: Classifier, concept_extractor: ConceptExtractor,
                 explainer: Explainer, gan: GeneratorAdapted):
        super().__init__()
        self.classifier = classifier
        self.concept_extractor = concept_extractor
        self.explainer = explainer
        self.gan = gan

    def classify(self, images: torch.Tensor):
        """f(x) -> (logits, hidden_states)."""
        return self.classifier(images)

    def extract_concepts(self, hidden_states):
        """Psi(hidden[-3:]) -> (Phi, Phi')."""
        return self.concept_extractor(tuple(hidden_states[-3:]))

    def explain(self, phi: torch.Tensor) -> torch.Tensor:
        """Theta(Phi) -> logits."""
        return self.explainer(phi)

    def reconstruct(self, phi, phi_prime, noise_mode: str = "const",
                    return_latents: bool = False, generator: torch.Generator | None = None):
        """G(z1=Phi, z2=Phi') -> image (and optionally W+)."""
        return self.gan(phi, phi_prime, return_latents=return_latents, noise_mode=noise_mode,
                        generator=generator)

    def forward_all(self, images: torch.Tensor, noise_mode: str = "const",
                    generator: torch.Generator | None = None) -> dict:
        logits, hidden = self.classify(images)
        phi, phi_prime = self.extract_concepts(hidden)
        expl_logits = self.explain(phi)
        recon, ws = self.reconstruct(phi, phi_prime, noise_mode=noise_mode,
                                     return_latents=True, generator=generator)
        return {"logits": logits, "phi": phi, "phi_prime": phi_prime,
                "explainer_logits": expl_logits, "reconstruction": recon, "ws": ws}

    forward = forward_all


def default_models(n_classes: int = 200, n_concepts: int = 256, img_resolution: int = 256,
                   channel_base: int = 32768, channel_max: int = 512, *,
                   device="cuda", seed: int = 0) -> VisCoINModels:
    """The ensemble with the reference's default hyperparameters, built on
    ``device`` with random weights from ``seed``."""
    models = VisCoINModels(
        classifier=Classifier(output_classes=n_classes, device=device),
        concept_extractor=ConceptExtractor(n_concepts=n_concepts, device=device),
        explainer=Explainer(n_concepts=n_concepts, n_classes=n_classes, device=device),
        gan=GeneratorAdapted(z_dim=n_concepts, img_resolution=img_resolution,
                             channel_base=channel_base, channel_max=channel_max,
                             device=device),
    )
    return init_models(models, seed)


@torch.no_grad()
def init_models(models: nn.Module, seed: int = 0) -> nn.Module:
    """Random-initialize every parameter and buffer from ``seed``, on the
    device the modules live on, with the JAX package's initializers."""
    device = next(models.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    for m in models.modules():
        init = getattr(m, "init_weights", None)
        if init is not None:
            init(generator)
    return models
