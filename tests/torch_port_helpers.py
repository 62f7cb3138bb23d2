"""Shared set-up for the tests of the PyTorch port (tests/test_torch_*.py):
a toy VisCoIN bundle built in the JAX package, its variables perturbed with
seeded numpy values (fresh init leaves biases, noise strengths, fixed_w_avg
and BN statistics at 0 or identity, which would hide layout errors), and the
same bundle in the port with the variables carried across."""

import numpy as np
import pytest
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


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Import into a test module to run its torch work on one intra-op
    thread: toy widths gain nothing from more, and the suite runs several
    test processes at once, whose thread pools would contend for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def perturb(tree, seed: int):
    """Every float leaf + 0.1 * N(0, 1); BN variances drawn from U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        if getattr(path[-1], "key", None) == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def run_once(fn, *args):
    """``fn(*args)`` jitted and compiled without XLA's backend optimisations:
    for programs that run once, such as initialisers, whose full compile is
    most of a test module's set-up."""
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})(*args)


def _init(models: VisCoINModels, rng, image_size: int):
    """The variables ``viscoin_tpu.models.bundle.init_models`` draws: its
    own jitted program, which tracing inlines here."""
    m = init_models(VisCoINModels(models.classifier, models.concept_extractor, models.explainer,
                                  models.gan), rng, image_size=image_size)
    return m.classifier_vars, m.concept_params, m.explainer_params, m.gan_vars


def jax_bundle(normalized: bool = False, seed: int = 0, img: int = IMG,
               n_classes: int = NC) -> VisCoINModels:
    m = VisCoINModels(
        classifier=Classifier(**dict(CLASSIFIER, output_classes=n_classes)),
        concept_extractor=ConceptExtractor(**PSI),
        explainer=Explainer(n_concepts=NK, n_classes=n_classes, normalized=normalized),
        gan=GeneratorAdapted(**dict(GAN, img_resolution=img)),
    )
    (m.classifier_vars, m.concept_params, m.explainer_params,
     m.gan_vars) = run_once(lambda key: _init(m, key, img), jax.random.PRNGKey(seed))
    m.classifier_vars = perturb(m.classifier_vars, seed + 1)
    m.concept_params = perturb(m.concept_params, seed + 2)
    m.explainer_params = perturb(m.explainer_params, seed + 3)
    m.gan_vars = perturb(m.gan_vars, seed + 4)
    return m


def jax_variables(m: VisCoINModels) -> dict:
    """The dict the JAX InferenceEngine builds from a bundle."""
    return {"classifier": m.classifier_vars, "psi": m.concept_params,
            "theta": m.explainer_params, "gan": m.gan_vars}


def _torch_modules(normalized: bool = False, img: int = IMG,
                   n_classes: int = NC) -> tb.VisCoINModels:
    return tb.VisCoINModels(
        classifier=TClassifier(**dict(CLASSIFIER, output_classes=n_classes), device="cpu"),
        concept_extractor=TConceptExtractor(**PSI, device="cpu"),
        explainer=TExplainer(n_concepts=NK, n_classes=n_classes, normalized=normalized,
                             device="cpu"),
        gan=TGeneratorAdapted(**dict(GAN, img_resolution=img), device="cpu"),
    )


def torch_bundle(m: VisCoINModels, normalized: bool = False, img: int = IMG,
                 n_classes: int = NC) -> tb.VisCoINModels:
    models = _torch_modules(normalized, img, n_classes)
    return load_jax_variables(models, jax_variables(m)).eval()


def bundle_pair(seed: int = 0, img: int = IMG, n_classes: int = NC):
    """(JAX bundle, port bundle) at the toy widths above with the same
    perturbed variables, drawn without compiling JAX's initialiser: the port
    initialises from ``seed``, and its tree in the JAX layout, perturbed, is
    given to both."""
    from viscoin_tpu_torch.utils.weights import bundle_to_jax_tree

    tm = tb.init_models(_torch_modules(img=img, n_classes=n_classes), seed)
    tree = bundle_to_jax_tree(tm)
    m = VisCoINModels(
        classifier=Classifier(**dict(CLASSIFIER, output_classes=n_classes)),
        concept_extractor=ConceptExtractor(**PSI),
        explainer=Explainer(n_concepts=NK, n_classes=n_classes),
        gan=GeneratorAdapted(**dict(GAN, img_resolution=img)),
    )
    (m.classifier_vars, m.concept_params, m.explainer_params, m.gan_vars) = (
        perturb(tree[k], seed + i) for i, k in enumerate(
            ("classifier", "concept_extractor", "explainer", "gan"), start=1))
    return m, load_jax_variables(tm, jax_variables(m)).eval()


def save_jax_bundle(m: VisCoINModels, path: str) -> str:
    """``m`` written as the JAX package writes a bundle in its npz layout (its
    own key flattening and module config; its single-process save is orbax,
    which the port does not read)."""
    import json
    import os

    from viscoin_tpu.utils import checkpoints as jckpt

    tree = {"classifier": m.classifier_vars, "concept_extractor": m.concept_params,
            "explainer": m.explainer_params, "gan": m.gan_vars}
    keys, vals, _ = jckpt._flat_keys(tree)
    os.makedirs(path)
    np.savez(os.path.join(path, "arrays.npz"), **dict(zip(keys, [np.asarray(v) for v in vals])))
    with open(os.path.join(path, "viscoin_config.json"), "w") as f:
        json.dump(jckpt._module_config(m), f)
    return path


def images(n: int, size: int = IMG, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


def jax_augment_draws(key, batch: int):
    """The random numbers JAX's ``viscoin_tpu.train.augment.augment`` draws
    from ``key`` for ``batch`` images (its lines 138-275, in order), as the
    port's ``AugmentDraws``."""
    from viscoin_tpu_torch.train.augment import AugmentDraws

    keys = jax.random.split(key, 16)
    ck = jax.random.split(keys[15], 10)
    u = lambda k, lo=0.0, hi=1.0: jax.random.uniform(k, (batch,), minval=lo, maxval=hi)  # noqa
    n = lambda k, *shape: jax.random.normal(k, (batch, *shape))  # noqa
    pi = np.pi
    arrays = dict(
        flip_do=u(keys[0]), flip_coin=u(keys[1]), r90_do=u(keys[2]),
        r90_k=jax.random.randint(keys[3], (batch,), 0, 4), xint_do=u(keys[4]),
        tx=u(keys[5], -0.125, 0.125), ty=u(keys[6], -0.125, 0.125), iso_do=u(keys[7]),
        iso=n(keys[8]), rot_do=u(keys[9]), theta=u(keys[10], -pi, pi), aniso_do=u(keys[11]),
        aniso=n(keys[12]), frac_do=u(keys[13]), frac=n(keys[14], 2),
        bright_do=u(ck[0]), bright=n(ck[1]), contrast_do=u(ck[2]), contrast=n(ck[3]),
        lumaflip_do=u(ck[4]), lumaflip_coin=u(ck[5]), hue_do=u(ck[6]), hue=u(ck[7], -pi, pi),
        sat_do=u(ck[8]), sat=n(ck[9]))
    return AugmentDraws.from_arrays({k: np.asarray(v) for k, v in arrays.items()})


# The toy generator of the JAX package's GAN-tool tests (tests/test_cli_fid.py).
TOY_GEN = dict(z_dim=8, w_dim=16, img_resolution=32, mapping_layers=2, channel_base=256,
               channel_max=16)


def jax_generator(seed: int = 0, **overrides):
    """A JAX ``Generator`` at toy widths with its variables ({params, noise,
    moving_stats}) perturbed: (module, numpy variables)."""
    import jax.numpy as jnp

    from viscoin_tpu.models.stylegan import Generator

    cfg = dict(TOY_GEN, **overrides)
    g = Generator(**cfg)
    gvars = run_once(lambda key: g.init({"params": key}, jnp.zeros((1, cfg["z_dim"])),
                                        noise_mode="const"), jax.random.PRNGKey(seed))
    gvars = perturb(jax.tree_util.tree_map(np.asarray, dict(gvars)), seed + 1)
    return g, jax.tree_util.tree_map(np.asarray, gvars)


def save_generator(gvars: dict, path: str) -> str:
    """The variables in the npz layout, where ``--gan`` reads them."""
    from viscoin_tpu_torch.utils import checkpoints as ckpt

    ckpt.save_pytree(gvars, path)
    ckpt.wait_for_saves()
    return path
