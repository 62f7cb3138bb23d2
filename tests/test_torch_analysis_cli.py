"""The analysis commands of a trained bundle (``amplify``, ``amplify-pca``,
``concepts``, ``concept-heatmaps``, ``logs``, ``to-pickle``) run in this
process on the CPU, each writing its figures, on the toy bundle of
``tests/test_cli_analytics.py`` (32², 10 classes, 8 concepts) as the JAX
package writes it, over ``SyntheticDataset``; ``amplify-pca``'s images
against the JAX generator's."""

import json
import os

import numpy as np
import pytest

import jax

from torch_port_helpers import bundle_pair, save_jax_bundle
from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from viscoin_tpu.utils.images import from_jax
from viscoin_tpu_torch.__main__ import main
from viscoin_tpu_torch.cli import amplify_pca as pca_cmd
from viscoin_tpu_torch.eval import concepts as TC
from viscoin_tpu_torch.train.viscoin import TRAIN_METRICS
from viscoin_tpu_torch.utils import checkpoints as ckpt
from viscoin_tpu_torch.utils.types import TestingResults

IMG, NC = 32, 10
SELECTIONS = {"top-k": ["--concept-top-k", "2"], "indices": ["--concept-indices", "0,3"],
              "threshold": ["--concept-threshold", "0.2"]}


@pytest.fixture(scope="module")
def pair():
    return bundle_pair(seed=7, img=IMG, n_classes=NC)


@pytest.fixture(scope="module")
def bundle(pair, tmp_path_factory):
    return save_jax_bundle(pair[0], str(tmp_path_factory.mktemp("ckpt") / "viscoin-toy"))


@pytest.fixture(autouse=True)
def synth_env(monkeypatch, tmp_path):
    monkeypatch.setenv("VISCOIN_SYNTH_N", "6")
    monkeypatch.setenv("VISCOIN_SYNTH_SIZE", str(IMG))
    monkeypatch.chdir(tmp_path)


def run(*argv) -> None:
    assert main(list(argv)) == 0


def _common(bundle):
    return ["--viscoin-pickle-path", bundle, "--device", "cpu", "--dataset", "synthetic",
            "--outdir", "figs"]


@pytest.mark.parametrize("selection", list(SELECTIONS), ids=list(SELECTIONS))
def test_amplify_command(bundle, selection, capsys):
    run("amplify", *_common(bundle), *SELECTIONS[selection], "--image-indices", "0,1")
    assert os.path.getsize("figs/amplify.png") > 0
    assert "amplified images [0, 1]" in capsys.readouterr().out


def test_amplify_without_a_selection_raises(bundle):
    with pytest.raises(ValueError, match="concept-threshold or concept-top-k"):
        main(["amplify", *_common(bundle), "--image-indices", "0"])


def test_amplify_pca_command_and_its_images_match_jax(pair, bundle, capsys):
    """--pca 6: two figures of up to 5 components; W+ cached under the JAX
    command's name; one component's 5 images (one gen_from_w call) against
    the JAX generator's on the same latents."""
    run("amplify-pca", *_common(bundle), "--pca", "6", "--image", "0")
    assert sorted(os.listdir("figs")) == ["amplify_pca_0.png", "amplify_pca_1.png"]
    assert os.listdir("checkpoints/gan-w") == [f"synthetic_{IMG}.npz"]
    assert "Amplifying image n° 0" in capsys.readouterr().out
    jm, tm = pair
    with np.load(f"checkpoints/gan-w/synthetic_{IMG}.npz") as data:
        train_w, test_w = data["train"], data["test"]
    comps = pca_cmd.pca_components(train_w, 2)
    assert comps.shape == (2, *train_w.shape[1:])
    got = pca_cmd.pca_images(tm, test_w[0], comps)
    assert got.shape == (2, len(pca_cmd.MULTIPLIERS), IMG, IMG, 3)
    w = test_w[0][None] + comps[1][None] * np.asarray(pca_cmd.MULTIPLIERS, np.float32)[:, None,
                                                                                      None]
    want = jax.jit(lambda v, w: jm.gan.apply(v, w, noise_mode="const",
                                             method=jm.gan.gen_from_w))(jm.gan_vars, w)
    np.testing.assert_allclose(got[1], from_jax(np.asarray(want)), rtol=0, atol=1e-4)


def test_concepts_command_caches_its_results(bundle, capsys, monkeypatch):
    run("concepts", *_common(bundle), "--batch-size", "4")
    assert os.path.exists("concept_results.pkl")
    figures = sorted(os.listdir("figs"))
    assert figures == sorted(f"{n}.png" for n in (
        "concept_activation_per_concept", "concept_activation_per_image",
        "class_concept_correlations", "concept_class_correlations", "concept_entropies"))
    assert "Classifier accuracy" in capsys.readouterr().out

    def recompute(*args):
        raise AssertionError("recomputed despite the cache")

    monkeypatch.setattr(TC, "test_concepts", recompute)
    run("concepts", *_common(bundle))  # the cached second run
    assert "Explainer accuracy" in capsys.readouterr().out
    with pytest.raises(AssertionError, match="recomputed"):
        main(["concepts", *_common(bundle), "--force"])


def test_concept_heatmaps_command(bundle, capsys, monkeypatch):
    """The 5 images come from an unseeded generator in the command (as in
    JAX's); here a seeded one."""
    default_rng = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng", lambda *a: default_rng(0))
    run("concept-heatmaps", *_common(bundle))
    assert os.path.getsize("figs/concept_heatmaps.png") > 0
    want = [int(i) for i in default_rng(0).choice(6, 5, replace=False)]
    assert f"heatmaps of images {want}" in capsys.readouterr().out


def _write_jsonl(path: str, records: list[dict], truncated: bool = False) -> str:
    with open(path, "w") as f:
        f.write("\n".join(json.dumps(r) for r in records) + "\n")
        if truncated:
            f.write('{"train_acc_loss": 0.')
    return path


def test_logs_command_plots_every_schema(capsys):
    """train viscoin's schema (a truncated last line dropped), train gan's,
    the classifier's; an unknown key in a viscoin log raises."""
    test_keys = [f.name for f in TestingResults.__dataclass_fields__.values()]
    viscoin = [{**{f"train_{k}": 1.0 + i for k in TRAIN_METRICS},
                **{f"test_{k}": 0.5 * i for k in test_keys}} for i in range(3)]
    gan = [{"iteration": 100 * i, "g_loss": 1.0, "d_loss": 2.0, "r1": 0.1} for i in range(3)]
    gan.append({"iteration": 300, "fid": 40.0})
    cls = [{"train_accuracy": 0.1 * i, "test_accuracy": 0.2 * i, "train_loss": 1.0}
           for i in range(3)]
    for name, records, figures in (
            ("viscoin", viscoin, ["preds_overlap", "testing_losses", "training_losses"]),
            ("gan", gan, ["gan_logs"]), ("cls", cls, ["training_curves"])):
        run("logs", "--logs-path", _write_jsonl(f"{name}.jsonl", records, name == "viscoin"),
            "--outdir", name)
        assert sorted(os.listdir(name)) == [f"{f}.png" for f in figures], name
    with pytest.raises(ValueError, match="Unknown key: epoch"):
        main(["logs", "--logs-path", _write_jsonl("x.jsonl", [{**viscoin[0], "epoch": 1}])])


def test_to_pickle_command(pair, bundle, monkeypatch):
    """A raw joint checkpoint re-saved with the default hyperparameters
    (`default_models` patched to the toy widths): the bundle loads with the same
    weights."""
    from viscoin_tpu_torch.models import bundle as tb

    jm, tm = pair
    raw = "raw"
    ckpt.save_pytree(ckpt.restore_pytree(bundle), raw)  # the arrays without the config
    assert not os.path.exists(os.path.join(raw, "viscoin_config.json"))
    monkeypatch.setattr(tb, "default_models",
                        lambda device: bundle_pair(seed=8, img=IMG, n_classes=NC)[1].to(device))
    run("to-pickle", "--checkpoints", raw, "--output", "out", "--device", "cpu")
    loaded = ckpt.load_viscoin_bundle("out", device="cpu")
    want = tm.state_dict()
    assert sorted(loaded.state_dict()) == sorted(want)
    for k, v in loaded.state_dict().items():
        assert np.array_equal(v.numpy(), want[k].numpy()), k


@pytest.mark.parametrize("argv", [
    ["amplify", "--concept-top-k", "1", "--image-indices", "0"],
    ["amplify-pca", "--pca", "2", "--image", "0"], ["concepts", "--batch-size", "4"],
    ["concept-heatmaps"], ["logs", "--logs-path", "viscoin.jsonl"]], ids=lambda a: a[0])
def test_drawing_commands_run_without_matplotlib(bundle, monkeypatch, argv):
    """With matplotlib unimportable (as on the card's machines) each drawing
    command runs to its PNGs, each of its figure's size times 100 pixels."""
    import sys

    from PIL import Image

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        import matplotlib  # noqa: F401
    test_keys = [f.name for f in TestingResults.__dataclass_fields__.values()]
    _write_jsonl("viscoin.jsonl", [{**{f"train_{k}": 1.0 + i for k in TRAIN_METRICS},
                                    **{f"test_{k}": 0.5 * i for k in test_keys}}
                                   for i in range(2)])
    args = argv + (["--viscoin-pickle-path", bundle, "--device", "cpu", "--dataset",
                    "synthetic"] if argv[0] != "logs" else []) + ["--outdir", "figs"]
    run(*args)
    small = (640, 480)
    want = {"amplify": {"amplify": (1500, 500)},
            "amplify-pca": {"amplify_pca_0": (1500, 1000)},
            "concepts": dict.fromkeys(["concept_activation_per_concept",
                                       "concept_activation_per_image",
                                       "class_concept_correlations",
                                       "concept_class_correlations", "concept_entropies"], small),
            "concept-heatmaps": {"concept_heatmaps": (2000, 1000)},
            "logs": dict.fromkeys(["training_losses", "testing_losses", "preds_overlap"],
                                  small)}[argv[0]]
    assert sorted(os.listdir("figs")) == sorted(f"{n}.png" for n in want)
    for name, size in want.items():
        with Image.open(f"figs/{name}.png") as img:
            assert (img.format, img.size) == ("PNG", size), name
