"""Shared set-up for the tests of the PyTorch port (tests/test_torch_*.py):
a toy VisCoIN bundle built in the JAX package, its variables perturbed with
seeded numpy values (fresh init leaves biases, noise strengths, fixed_w_avg
and BN statistics at 0 or identity, which would hide layout errors), and the
same bundle in the port with the variables carried across."""

import numpy as np
import torch

import jax

from viscoin_tpu.models.bundle import VisCoINModels, init_models
from viscoin_tpu.models.concept_extractor import ConceptExtractor
from viscoin_tpu.models.explainer import Explainer
from viscoin_tpu.models.resnet import Classifier
from viscoin_tpu.models.stylegan import GeneratorAdapted
from viscoin_tpu_torch.models import bundle as tb
from viscoin_tpu_torch.models.concept_extractor import ConceptExtractor as TConceptExtractor
from viscoin_tpu_torch.models.explainer import Explainer as TExplainer
from viscoin_tpu_torch.models.resnet import Classifier as TClassifier
from viscoin_tpu_torch.models.stylegan import GeneratorAdapted as TGeneratorAdapted
from viscoin_tpu_torch.utils.weights import load_jax_variables

# The geometry of tests/test_serving.py.
IMG, NC, NK = 32, 5, 8
CLASSIFIER = dict(output_classes=NC, embedding_size=8, hidden_sizes=(8, 16, 32, 64),
                  depths=(1, 1, 1, 1))
PSI = dict(n_concepts=NK, latent_channels=8, input_channels1=16, input_channels2=32,
           input_channels3=64)
GAN = dict(z_dim=NK, w_dim=32, img_resolution=IMG, channel_base=256, channel_max=16)


def perturb(tree, seed: int):
    """Every float leaf + 0.1 * N(0, 1); BN variances drawn from U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        if getattr(path[-1], "key", None) == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def jax_bundle(normalized: bool = False, seed: int = 0, img: int = IMG) -> VisCoINModels:
    m = VisCoINModels(
        classifier=Classifier(**CLASSIFIER),
        concept_extractor=ConceptExtractor(**PSI),
        explainer=Explainer(n_concepts=NK, n_classes=NC, normalized=normalized),
        gan=GeneratorAdapted(**dict(GAN, img_resolution=img)),
    )
    m = init_models(m, jax.random.PRNGKey(seed), image_size=img)
    m.classifier_vars = perturb(m.classifier_vars, seed + 1)
    m.concept_params = perturb(m.concept_params, seed + 2)
    m.explainer_params = perturb(m.explainer_params, seed + 3)
    m.gan_vars = perturb(m.gan_vars, seed + 4)
    return m


def jax_variables(m: VisCoINModels) -> dict:
    """The dict the JAX InferenceEngine builds from a bundle."""
    return {"classifier": m.classifier_vars, "psi": m.concept_params,
            "theta": m.explainer_params, "gan": m.gan_vars}


def torch_bundle(m: VisCoINModels, normalized: bool = False, img: int = IMG) -> tb.VisCoINModels:
    models = tb.VisCoINModels(
        classifier=TClassifier(**CLASSIFIER, device="cpu"),
        concept_extractor=TConceptExtractor(**PSI, device="cpu"),
        explainer=TExplainer(n_concepts=NK, n_classes=NC, normalized=normalized,
                             device="cpu"),
        gan=TGeneratorAdapted(**dict(GAN, img_resolution=img), device="cpu"),
    )
    return load_jax_variables(models, jax_variables(m)).eval()


def images(n: int, size: int = IMG, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()
