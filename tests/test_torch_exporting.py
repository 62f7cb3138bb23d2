"""Exporting from the PyTorch port (``viscoin_tpu_torch/utils/exporting.py``
and ``port-weights export-*``) against the JAX package's exporters, and the
reference's state_dicts loaded into the port's modules through
``utils/porting.py::load_torch_*`` against the JAX modules:

  * export then import gives the bit-equal tree, for every kind; the port's
    export equals JAX's export of the same variables, key for key;
  * a port module loaded from a reference state_dict (JAX's export of
    perturbed JAX variables) gives the JAX module's output within 1e-5 of
    its scale;
  * ``port-weights export-viscoin`` and ``export-classifier`` write what the
    exporters give.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_gan import D_KW, G_KW, jax_nets
from test_torch_porting import assert_trees_equal
from torch_port_helpers import CLASSIFIER, PSI, jax_bundle, nchw, nhwc, torch_bundle
from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from viscoin_tpu.utils import exporting as jexp
from viscoin_tpu_torch.__main__ import main
from viscoin_tpu_torch.models import stylegan as tsg
from viscoin_tpu_torch.models.bundle import VisCoINModels
from viscoin_tpu_torch.models.concept_extractor import ConceptExtractor
from viscoin_tpu_torch.models.explainer import Explainer
from viscoin_tpu_torch.models.resnet import Classifier
from viscoin_tpu_torch.utils import checkpoints as ckpt
from viscoin_tpu_torch.utils import exporting, porting
from viscoin_tpu_torch.utils.weights import module_to_jax_tree

TOL = 1e-5


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jm():
    return jax_bundle(normalized=True)


@pytest.fixture(scope="module")
def gan_vars():
    _, _, gv, dv = jax_nets()
    return _np(gv), _np(dv)["params"]


def _kinds(jm, gan_vars):
    """(kind, variables, port export, JAX export, converter back) per kind."""
    gv, dv = gan_vars
    gan = jm.gan
    adapted = dict(num_ws=gan.num_ws, num_layers=gan.mapping_num_layers,
                   coarse_layer=gan.coarse_layer, mid_layer=gan.mid_layer)
    ga_vars = _np(jm.gan_vars)
    return {
        "classifier": (_np(jm.classifier_vars), exporting.export_classifier_torch,
                       jexp.export_classifier_torch, porting.convert_torch_classifier),
        "concept_extractor": (_np(jm.concept_params), exporting.export_concept_extractor_torch,
                              jexp.export_concept_extractor_torch,
                              porting.convert_torch_concept_extractor),
        "explainer": (_np(jm.explainer_params), exporting.export_explainer_torch,
                      jexp.export_explainer_torch, porting.convert_torch_explainer),
        "generator": (gv, exporting.export_generator_torch, jexp.export_generator_torch,
                      porting.convert_torch_generator),
        "generator_adapted": (
            ga_vars, lambda v: exporting.export_generator_adapted_torch(v, **adapted),
            lambda v: jexp.export_generator_adapted_torch(v, **adapted),
            lambda sd: porting.convert_torch_generator_adapted(
                sd, num_layers=adapted["num_layers"], coarse_layer=adapted["coarse_layer"],
                mid_layer=adapted["mid_layer"])),
        "discriminator": (dv, exporting.export_discriminator_torch,
                          jexp.export_discriminator_torch, porting.convert_torch_discriminator),
    }


@pytest.mark.parametrize("kind", ["classifier", "concept_extractor", "explainer", "generator",
                                  "generator_adapted", "discriminator"])
def test_export_then_import_is_bit_equal_and_matches_jax(jm, gan_vars, kind):
    variables, export, jax_export, convert = _kinds(jm, gan_vars)[kind]
    sd = export(variables)
    want = jax_export(variables)
    assert set(sd) == set(want)
    for k in sd:
        np.testing.assert_array_equal(sd[k], want[k], err_msg=k)
        assert np.asarray(sd[k]).dtype == np.asarray(want[k]).dtype, k
    assert_trees_equal(convert(sd), variables)


def test_loaded_bundle_matches_jax(jm):
    """The reference's joint state_dict (JAX's export of the toy bundle,
    weight-norm explainer) loaded through load_torch_* into the port's
    modules: logits, the 5 hidden states, Phi, Phi', the explainer's logits
    and the reconstruction within 1e-5 of JAX's."""
    joint = jexp.export_viscoin_torch(jm)
    gan = jm.gan
    models = VisCoINModels(
        classifier=Classifier(**CLASSIFIER, device="cpu"),
        concept_extractor=ConceptExtractor(**PSI, device="cpu"),
        explainer=Explainer(n_concepts=jm.concept_extractor.n_concepts,
                            n_classes=CLASSIFIER["output_classes"], normalized=True,
                            device="cpu"),
        gan=tsg.GeneratorAdapted(z_dim=gan.z_dim, w_dim=gan.w_dim,
                                 img_resolution=gan.img_resolution,
                                 channel_base=gan.channel_base, channel_max=gan.channel_max,
                                 device="cpu"))
    porting.load_torch_classifier(models.classifier, joint["classifier"])
    porting.load_torch_concept_extractor(models.concept_extractor, joint["concept_extractor"])
    porting.load_torch_explainer(models.explainer, joint["explainer"])
    porting.load_torch_generator_adapted(models.gan, joint["gan"])
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jm.forward_all(x))(None, jnp.asarray(x))
    with torch.no_grad():
        got = models.eval().forward_all(nchw(x))
    _close(got["logits"].numpy(), want["logits"])
    _close(nhwc(got["phi"]), want["phi"])
    _close(got["phi_prime"].numpy(), want["phi_prime"])
    _close(got["explainer_logits"].numpy(), want["explainer_logits"])
    _close(nhwc(got["reconstruction"]), want["reconstruction"])


def test_loaded_generator_and_discriminator_match_jax(gan_vars):
    """NVlabs-naming state_dicts (JAX's export) through load_torch_generator
    and load_torch_discriminator: G(z) (constant noise) and D(x) within 1e-5."""
    jg, jd, gv, dv = jax_nets()
    tg = porting.load_torch_generator(tsg.Generator(**G_KW, device="cpu"),
                                      jexp.export_generator_torch(_np(gv)))
    td = porting.load_torch_discriminator(tsg.Discriminator(**D_KW, device="cpu"),
                                          jexp.export_discriminator_torch(_np(dv)["params"]))
    rng = np.random.default_rng(1)
    z = rng.standard_normal((2, G_KW["z_dim"])).astype(np.float32)
    img = jax.jit(lambda v, z: jg.apply(v, z, noise_mode="const"))(gv, jnp.asarray(z))
    d = jax.jit(jd.apply)(dv, img)
    with torch.no_grad():
        timg = tg(torch.from_numpy(z), noise_mode="const")
        _close(nhwc(timg), img)
        _close(td(nchw(np.asarray(img))).numpy(), d)


def test_export_commands_write_the_exporters_dicts(jm, tmp_path):
    """`port-weights export-viscoin` on a bundle the port saved and
    `export-classifier` on a classifier checkpoint: the written state_dicts
    equal the exporters' output on the same variables (and JAX's)."""
    models = torch_bundle(jm, normalized=True)
    ckpt.save_viscoin(models, str(tmp_path / "bundle"))
    ckpt.save_pytree(module_to_jax_tree(models.classifier), str(tmp_path / "classifier"))
    ckpt.wait_for_saves()
    assert main(["port-weights", "export-viscoin", str(tmp_path / "bundle"),
                 str(tmp_path / "viscoin.pth"), "--device", "cpu"]) == 0
    assert main(["port-weights", "export-classifier", str(tmp_path / "classifier"),
                 str(tmp_path / "classifier.pth"), "--device", "cpu"]) == 0
    joint = torch.load(tmp_path / "viscoin.pth", weights_only=True)
    want = jexp.export_viscoin_torch(jm)
    assert set(joint) == set(want)
    for m, sd in want.items():
        assert set(joint[m]) == set(sd), m
        for k, v in sd.items():
            np.testing.assert_array_equal(joint[m][k].numpy(), np.asarray(v), err_msg=f"{m}.{k}")
    cls = torch.load(tmp_path / "classifier.pth", weights_only=True)
    for k, v in want["classifier"].items():
        np.testing.assert_array_equal(cls[k].numpy(), np.asarray(v), err_msg=k)
