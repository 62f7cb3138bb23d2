"""Weight porting into the PyTorch port (``viscoin_tpu_torch/utils/porting.py``
and ``cli/port_weights.py``) against the JAX package's converters
(``viscoin_tpu/utils/porting.py``, ``scripts/port_weights.py``), numpy only:

  * each converter gives the bit-equal tree from the same state_dict, built
    from the checked-in manifests at the reference networks' full shapes,
    or for the kinds without a manifest from the JAX exporter;
  * ``validate_state_dict`` reports what JAX's reports, plus a one_of
    member's shape that JAX's leaves unchecked;
  * an NVlabs network pickle, fabricated with the persistence layout and
    without the NVlabs code, yields the G and D trees the JAX script gives;
  * ``port-weights --check`` exits 0 on a clean source and 1 on a mis-shaped
    one, and ``port-weights stylegan`` writes what ``export-stylegan`` reads
    back to the source state_dict.
"""

import os
import pickle
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from viscoin_tpu.utils import exporting as jexp
from viscoin_tpu.utils import porting as jport
from viscoin_tpu_torch.__main__ import main
from viscoin_tpu_torch.cli import port_weights as pw
from viscoin_tpu_torch.models.bundle import init_models
from viscoin_tpu_torch.models.stylegan import Discriminator, Generator, GeneratorAdapted
from viscoin_tpu_torch.utils import porting
from viscoin_tpu_torch.utils import checkpoints as ckpt
from viscoin_tpu_torch.utils.weights import module_to_jax_tree

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
BUFFERS = ("w_avg", "noise_const", "resample_filter", "running_mean", "running_var",
           "num_batches_tracked")


def build_sd(kind: str, wildcard: int = 200, seed: int = 0) -> dict[str, np.ndarray]:
    """A random state_dict realising a manifest (required and optional keys;
    the alternate ``lins.`` naming of LPIPS's heads left out; NVlabs'
    constant resample_filter buffers as NVlabs sets them)."""
    rng = np.random.default_rng(seed)
    man = porting.load_manifest(kind)
    out = {}
    for part in ("required", "optional"):
        for k, shape in man.get(part, {}).items():
            if k.endswith("resample_filter"):
                out[k] = jexp.RESAMPLE_FILTER.astype(np.float32)
            elif not k.startswith("lins."):
                out[k] = rng.standard_normal([wildcard if d == -1 else d for d in shape],
                                             dtype=np.float32)
    return out


def assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_manifests_are_the_jax_packages():
    for kind in porting.MANIFEST_KINDS:
        assert porting.load_manifest(kind) == jport.load_manifest(kind), kind


@pytest.mark.parametrize("kind, convert, jax_convert", [
    ("classifier", porting.convert_torch_classifier, jport.convert_torch_classifier),
    ("lpips", porting.convert_torch_lpips, jport.convert_torch_lpips),
    ("inception", porting.convert_torch_inception, jport.convert_torch_inception),
    ("stylegan_generator", porting.convert_torch_generator, jport.convert_torch_generator),
])
def test_converter_matches_jax_at_full_shape(kind, convert, jax_convert):
    """From the manifest's full shapes (ResNet-50 with 200 classes,
    LPIPS-VGG, pytorch-fid Inception, the 256² NVlabs generator), strictly
    validated: the trees are bit-equal."""
    sd = build_sd(kind)
    assert porting.validate_state_dict(sd, kind) == []
    got = convert(sd, strict=True)
    assert_trees_equal(got, jax_convert(sd, strict=True))


def _toy_trees():
    """Variables of the port's toy modules in the JAX layout."""
    g = init_models(Generator(z_dim=8, w_dim=16, img_resolution=16, channel_base=256,
                              channel_max=16, mapping_layers=2, device="cpu"), 1)
    d = init_models(Discriminator(img_resolution=16, channel_base=256, channel_max=16,
                                  device="cpu"), 2)
    ga = init_models(GeneratorAdapted(z_dim=8, w_dim=16, img_resolution=16, channel_base=256,
                                      channel_max=16, device="cpu"), 3)
    return module_to_jax_tree(g), module_to_jax_tree(d)["params"], module_to_jax_tree(ga)


@pytest.mark.parametrize("kind", ["discriminator", "generator_adapted", "concept_extractor",
                                  "explainer", "explainer_normalized"])
def test_converter_matches_jax_without_a_manifest(kind):
    """The kinds with no manifest, from state_dicts the JAX exporter makes of
    seeded trees: the port's converter and JAX's give bit-equal trees."""
    rng = np.random.default_rng(5)
    _, d, ga = _toy_trees()
    if kind == "discriminator":
        sd = jexp.export_discriminator_torch(d)
        got, want = porting.convert_torch_discriminator(sd), jport.convert_torch_discriminator(sd)
    elif kind == "generator_adapted":
        sd = jexp.export_generator_adapted_torch(ga, num_ws=6)
        got = porting.convert_torch_generator_adapted(sd)
        want = jport.convert_torch_generator_adapted(sd)
    elif kind == "concept_extractor":
        sd = {f"conv{i}.{p}": rng.standard_normal(s, dtype=np.float32)
              for i in range(1, 6) for p, s in (("weight", (4, 3, 3, 3)), ("bias", (4,)))}
        sd.update({"linear1.weight": rng.standard_normal((6, 5), dtype=np.float32),
                   "linear1.bias": rng.standard_normal(6, dtype=np.float32),
                   "linear2.weight": rng.standard_normal((6, 6), dtype=np.float32)})
        got = porting.convert_torch_concept_extractor(sd)
        want = jport.convert_torch_concept_extractor(sd)
    else:
        sd = {"linear.bias": rng.standard_normal(3, dtype=np.float32)}
        if kind == "explainer":
            sd["linear.weight"] = rng.standard_normal((3, 4), dtype=np.float32)
        else:
            sd["linear.parametrizations.weight.original0"] = rng.standard_normal(
                (3, 1), dtype=np.float32)
            sd["linear.parametrizations.weight.original1"] = rng.standard_normal(
                (3, 4), dtype=np.float32)
        got, want = porting.convert_torch_explainer(sd), jport.convert_torch_explainer(sd)
    assert_trees_equal(got, want)


def test_validation_reports_as_jax_does():
    """Missing, unexpected and mis-shaped keys, and an unsatisfied one_of
    group: the same report as the JAX package's; strict raises."""
    sd = build_sd("lpips")
    del sd["net.slice1.0.weight"]
    sd["net.slice9.0.weight"] = np.zeros((1,), np.float32)
    sd["net.slice1.2.bias"] = np.zeros((3,), np.float32)
    del sd["lin0.model.1.weight"]
    problems = porting.validate_state_dict(sd, "lpips", strict=False)
    assert problems == jport.validate_state_dict(sd, "lpips", strict=False)
    text = "\n".join(problems)
    for want in ("missing required key: net.slice1.0.weight",
                 "unexpected key: net.slice9.0.weight", "shape mismatch: net.slice1.2.bias",
                 "one of ['lin0.model.1.weight', 'lins.0.model.1.weight']"):
        assert want in text, want
    with pytest.raises(ValueError, match="net.slice1.0.weight"):
        porting.validate_state_dict(sd, "lpips")
    sd["lins.0.model.1.weight"] = np.zeros((1, 64, 1, 1), np.float32)
    sd["net.slice1.0.weight"] = np.zeros((64, 3, 3, 3), np.float32)
    del sd["net.slice9.0.weight"]
    sd["net.slice1.2.bias"] = np.zeros((64,), np.float32)
    assert porting.validate_state_dict(sd, "lpips", strict=False) == []
    for n_classes in (2, 555):
        assert porting.validate_state_dict(build_sd("classifier", n_classes),
                                           "classifier", strict=False) == []


def test_one_of_member_shape_is_checked(monkeypatch):
    """A one_of member without an entry of its own takes the shape of its
    group's member that has one, a scalar shape [] included. The JAX
    package looks only at the group's first member (which has none here)
    and treats [] as no shape, so it passes a mis-shaped key."""
    manifest = {"required": {}, "optional": {"s.old": []}, "one_of": [["s.new", "s.old"]]}
    monkeypatch.setattr(porting, "load_manifest", lambda kind: manifest)
    monkeypatch.setattr(jport, "load_manifest", lambda kind: manifest)
    sd = {"s.new": np.zeros((5,), np.float32)}
    assert jport.validate_state_dict(sd, "lpips", strict=False) == []
    assert porting.validate_state_dict(sd, "lpips", strict=False) == [
        "shape mismatch: s.new has [5], manifest expects []"]
    assert porting.validate_state_dict({"s.new": np.zeros((), np.float32)}, "lpips",
                                       strict=False) == []


# ------------------------------ NVlabs pickles ------------------------------- #


def _reconstruct_persistent_obj(meta):  # pickled by reference, as NVlabs' is
    return meta


_reconstruct_persistent_obj.__module__ = "torch_utils.persistence"


class _Persisted:
    """Pickles as a call to torch_utils.persistence._reconstruct_persistent_obj."""

    def __init__(self, meta):
        self.meta = meta

    def __reduce__(self):
        import torch_utils.persistence as pers

        return pers._reconstruct_persistent_obj, (self.meta,)


def _nest(sd: dict) -> dict:
    """A flat state_dict as nested NVlabs persistence metas: children under
    ``_modules``, tensors under ``_parameters`` or ``_buffers``."""
    root: dict = {}
    for key, value in sd.items():
        node = root
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value

    def meta(node: dict) -> dict:
        params = {k: torch.as_tensor(v) for k, v in node.items()
                  if not isinstance(v, dict) and k not in BUFFERS}
        buffers = {k: torch.as_tensor(v) for k, v in node.items()
                   if not isinstance(v, dict) and k in BUFFERS}
        modules = {k: _Persisted(meta(v)) for k, v in node.items() if isinstance(v, dict)}
        return {"type": "class", "version": 3, "module_src": "# source elided",
                "class_name": "Module", "state": {"training": False, "_parameters": params,
                                                  "_buffers": buffers, "_modules": modules}}

    return meta(root)


def fabricate_nvlabs_pickle(path: str, g_sd: dict, d_sd: dict) -> None:
    """{'G_ema': G, 'G': G, 'D': D} in the NVlabs persistence layout, written
    by a process where ``torch_utils`` exists only for the write."""
    pers = types.ModuleType("torch_utils.persistence")
    pers._reconstruct_persistent_obj = _reconstruct_persistent_obj
    tu = types.ModuleType("torch_utils")
    tu.persistence = pers
    sys.modules["torch_utils"], sys.modules["torch_utils.persistence"] = tu, pers
    try:
        g = _Persisted(_nest(g_sd))
        with open(path, "wb") as f:
            pickle.dump({"G_ema": g, "G": g, "D": _Persisted(_nest(d_sd))}, f)
    finally:
        del sys.modules["torch_utils"], sys.modules["torch_utils.persistence"]


@pytest.fixture(scope="module")
def nvlabs_pickle(tmp_path_factory):
    """The 256² generator of the manifest and a toy discriminator, NVlabs
    naming (with the resample_filter buffers the exporter rebuilds)."""
    g_sd = build_sd("stylegan_generator", seed=1)
    d_sd = jexp.export_discriminator_torch(_toy_trees()[1])
    path = str(tmp_path_factory.mktemp("nvlabs") / "network.pkl")
    fabricate_nvlabs_pickle(path, g_sd, d_sd)
    return path, g_sd, d_sd


def test_nvlabs_pickle_gives_the_jax_scripts_trees(nvlabs_pickle):
    from port_weights import load_nvlabs_pickle as jax_load_nvlabs_pickle

    path, g_sd, d_sd = nvlabs_pickle
    nets, jnets = pw.load_nvlabs_pickle(path), jax_load_nvlabs_pickle(path)
    assert "torch_utils" not in sys.modules
    g = porting.state_dict_to_numpy(pw.nvlabs_generator(nets))
    d = porting.state_dict_to_numpy(pw.nvlabs_discriminator(nets))
    assert set(g) == set(g_sd) and set(d) == set(d_sd)
    jg = jport.state_dict_to_numpy(jnets["G_ema"])
    jd = jport.state_dict_to_numpy(jnets["D"])
    assert_trees_equal(porting.convert_torch_generator(g, strict=True),
                       jport.convert_torch_generator(jg, strict=True))
    assert_trees_equal(porting.convert_torch_discriminator(d),
                       jport.convert_torch_discriminator(jd))
    assert_trees_equal(porting.convert_torch_generator(g), porting.convert_torch_generator(g_sd))


def test_port_weights_stylegan_and_export_round_trip(nvlabs_pickle, tmp_path, capsys):
    """`port-weights stylegan` on the pickle (loaded into the port's
    Generator and Discriminator on the CPU) writes G and D in the npz
    layout; `port-weights export-stylegan` gives back the source
    state_dicts bit for bit."""
    path, g_sd, d_sd = nvlabs_pickle
    dst = str(tmp_path / "gan-cub")
    assert main(["port-weights", "stylegan", path, dst, "--strict", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "manifest check [stylegan_generator]: OK" in out and ".discriminator" in out
    assert_trees_equal(ckpt.restore_pytree(dst), porting.convert_torch_generator(g_sd))
    exported = str(tmp_path / "gan.pth")
    assert main(["port-weights", "export-stylegan", dst, exported, "--device", "cpu"]) == 0
    for sd, file in ((g_sd, exported), (d_sd, exported + ".discriminator")):
        got = torch.load(file, weights_only=True)
        assert set(got) == set(sd)
        for k, v in sd.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_port_weights_check_exit_codes(tmp_path, capsys):
    """--check: 0 on a clean source, 1 on a mis-shaped one, nothing written."""
    sd = build_sd("lpips")
    clean, bad = str(tmp_path / "lpips.pth"), str(tmp_path / "bad.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, clean)
    sd["net.slice2.5.weight"] = sd["net.slice2.5.weight"][:, :, :2]
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, bad)
    for src, code in ((clean, 0), (bad, 1)):
        with pytest.raises(SystemExit) as done:
            main(["port-weights", "lpips", src, "--check", "--device", "cpu"])
        assert done.value.code == code
    assert "shape mismatch: net.slice2.5.weight" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(["port-weights", "lpips", bad, str(tmp_path / "out"), "--strict", "--device",
              "cpu"])
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("kind", ["clip", "export-concept2clip"])
def test_port_weights_unported_kinds_raise(kind, tmp_path, monkeypatch):
    """`clip` and `export-concept2clip` (ported) raise on a missing source
    before anything is written."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises((FileNotFoundError, ValueError), match="src"):
        main(["port-weights", kind, "src", "dst", "--device", "cpu"])
    assert os.listdir(".") == []


def test_port_weights_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["port-weights", "lpips", "src", "dst"])
