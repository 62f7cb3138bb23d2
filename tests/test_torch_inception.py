"""The FID detector of the PyTorch port (``viscoin_tpu_torch/models/inception.py``)
against the JAX package's (``viscoin_tpu/models/inception.py``):

  * InceptionV3Features at 75² (the least input it takes), batch 2, with
    the same perturbed variables: features within 1e-4 of their scale;
  * ``fid_preprocess`` (jax.image.resize's bilinear: half-pixel centres,
    renormalised border weights, antialiasing when shrinking),
    ``tf1_resize_bilinear`` and ``nvlabs_fid_preprocess`` at 256 -> 299 and
    at 320 -> 299;
  * the NVlabs TorchScript detector, fabricated as tests/test_nvlabs_fid.py
    fabricates it: the port runs the file as it is; the port's
    ``convert_torchscript_inception`` gives JAX's tree; ``port-weights
    inception-nvlabs`` checks and writes it, with the convention marker the
    commands' detector loader reads.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_nvlabs_fid import FabricatedNvlabsDetector
from test_torch_porting import assert_trees_equal
from torch_port_helpers import nchw, perturb, run_once
from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from viscoin_tpu.models import inception as jinc
from viscoin_tpu.utils.porting import convert_torchscript_inception as jax_convert_ts
from viscoin_tpu_torch.__main__ import main
from viscoin_tpu_torch.cli.train import _load_fid_detector
from viscoin_tpu_torch.models import inception as tinc
from viscoin_tpu_torch.utils import porting
from viscoin_tpu_torch.utils.weights import load_jax_tree, module_to_jax_tree

SIZES = (256, 320)  # upsampling (no antialiasing) and shrinking (antialiased) to 299


@pytest.fixture(scope="module")
def jax_inception():
    """The JAX module and seeded variables in its layout: the port's random
    init (its tree has the JAX module's structure, which ``apply`` checks),
    every leaf perturbed with numpy values; no JAX initialiser to compile."""
    torch.manual_seed(0)
    v = module_to_jax_tree(tinc.InceptionV3Features(device="cpu"))
    return jinc.InceptionV3Features(), jax.tree_util.tree_map(np.asarray, perturb(v, 1))


def test_features_match_jax(jax_inception):
    model, v = jax_inception
    x = np.random.default_rng(0).uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32)
    want = np.asarray(run_once(model.apply, v, jnp.asarray(x)))
    port = load_jax_tree(tinc.InceptionV3Features(device="cpu"), v).eval()
    with torch.no_grad():
        got = port(nchw(x)).numpy()
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("size", SIZES)
def test_preprocessing_matches_jax(size):
    """Normalized images -> the detector's 299² input, both conventions, and
    the TF1 resize alone, against JAX's jitted functions: within 5e-5 of the
    output's scale. JAX's own resize weights move by up to 1.3e-5 between
    its op-by-op and its jitted (fused float32) evaluation at 320 -> 299;
    the port takes the op-by-op ones (test_resize_weights_are_jaxs)."""
    x = np.random.default_rng(size).standard_normal((2, size, size, 3)).astype(np.float32)
    cases = ((tinc.fid_preprocess, jinc.fid_preprocess),
             (tinc.nvlabs_fid_preprocess, jinc.nvlabs_fid_preprocess),
             (lambda t: tinc.tf1_resize_bilinear(t, 299),
              lambda a: jinc.tf1_resize_bilinear(a, 299)))
    for port_fn, jax_fn in cases:
        want = np.asarray(jax.jit(jax_fn)(jnp.asarray(x)))
        got = port_fn(nchw(x)).permute(0, 2, 3, 1).numpy()
        assert got.shape == (2, 299, 299, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-5 * np.abs(want).max())


def test_resize_weights_are_jaxs():
    """The weight matrix of one axis is bit-equal to JAX's
    ``compute_weight_mat`` evaluated op by op, and within 2e-5 of what the
    jitted ``jax.image.resize`` applies to the unit vectors."""
    from jax._src.image import scale

    for n_in, n_out in ((320, 299), (256, 299)):
        got = tinc._resize_matrix(n_in, n_out)
        with jax.disable_jit():
            want = np.asarray(scale.compute_weight_mat(n_in, n_out, n_out / n_in, 0.0,
                                                       scale._fill_triangle_kernel, True))
        np.testing.assert_array_equal(got, want)
        eye = jnp.eye(n_in, dtype=jnp.float32)[:, :, None]
        jitted = np.asarray(jax.image.resize(eye, (n_in, n_out, 1), "bilinear"))[:, :, 0]
        np.testing.assert_allclose(got, jitted, rtol=0, atol=2e-5)


@pytest.fixture(scope="module")
def fabricated_pt(tmp_path_factory):
    """A full-width TorchScript detector in the NVlabs convention (its own
    resize to 299², then (x - 128) / 128), traced at 256²."""
    torch.manual_seed(0)
    det = FabricatedNvlabsDetector().eval()
    with torch.no_grad():
        for m in det.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.2, 0.2)
        ts = torch.jit.trace(det, torch.randn(1, 3, 256, 256))
    path = str(tmp_path_factory.mktemp("nvlabs") / "inception-fake.pt")
    ts.save(path)
    return path, det


def test_torchscript_detector_and_converter(fabricated_pt):
    """The TorchScript file runs as it is (the exact features); the port's
    converter gives JAX's tree bit for bit, and its detector the file's
    features at 299²."""
    path, det = fabricated_pt
    x = np.random.default_rng(1).uniform(-2.1, 2.6, (2, 3, 299, 299)).astype(np.float32)
    with torch.no_grad():
        want = det(torch.from_numpy(x)).numpy()
    got = tinc.make_torchscript_fid_detector(path, device="cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    module = torch.jit.load(path).eval()
    tree = porting.convert_torchscript_inception(module)
    assert_trees_equal(tree, jax.tree_util.tree_map(np.asarray, jax_convert_ts(module)))
    ported = tinc.make_nvlabs_fid_detector(tree, device="cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ported, want, rtol=0, atol=2e-4 * np.abs(want).max())


def test_port_weights_inception_nvlabs(fabricated_pt, tmp_path, capsys):
    """`port-weights inception-nvlabs` checks the ported detector against the
    file and writes the variables with fid_convention.json; the commands'
    loader then builds the NVlabs-convention detector from it."""
    path, _ = fabricated_pt
    dst = str(tmp_path / "inception")
    assert main(["port-weights", "inception-nvlabs", path, dst, "--device", "cpu"]) == 0
    assert "299² relative deviation" in capsys.readouterr().out
    with open(os.path.join(dst, "fid_convention.json")) as f:
        assert json.load(f) == {"convention": "nvlabs"}
    detect = _load_fid_detector(dst, torch.device("cpu"))
    assert "NVlabs-convention" in capsys.readouterr().out
    assert detect(torch.zeros(1, 3, 299, 299)).shape == (1, 2048)
