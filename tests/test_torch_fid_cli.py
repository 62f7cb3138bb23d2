"""``python -m viscoin_tpu_torch fid`` in-process at toy widths (z 8, w 16,
32², 2 mapping layers) with a traced 12-feature TorchScript detector:
FID, KID and precision/recall equal to the JAX package's ``eval/fid.py`` on
the same features (the real side one ordered pass over the train split with
the ``gan`` transform, the fake side batch j seeded ``fold_seed(--seed,
j)``); the real side read from a training zip equal to the folder it was
packed from; the JAX command's four refusals; ``--metric ppl`` through
LPIPS and through a TorchScript ``vgg16.pt``."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from test_cli_fid import _save_fake_vgg16_pt
from test_torch_classifier import TinyDetector
from torch_port_helpers import jax_generator, one_torch_thread, save_generator  # noqa: F401
from viscoin_tpu.eval import fid as JF
from viscoin_tpu_torch.__main__ import main
from viscoin_tpu_torch.cli.utils import load_generator
from viscoin_tpu_torch.data.utils import get_datasets
from viscoin_tpu_torch.eval import ppl as TP
from viscoin_tpu_torch.models.inception import make_torchscript_fid_detector
from viscoin_tpu_torch.models.lpips import LPIPS
from viscoin_tpu_torch.models.bundle import init_models
from viscoin_tpu_torch.train import gan as tgan
from viscoin_tpu_torch.utils import checkpoints as ckpt
from viscoin_tpu_torch.utils.weights import module_to_jax_tree


@pytest.fixture(scope="module")
def gan_path(tmp_path_factory):
    _, gvars = jax_generator(seed=8)
    return save_generator(gvars, str(tmp_path_factory.mktemp("fid") / "gan-toy"))


@pytest.fixture
def work(tmp_path, monkeypatch):
    monkeypatch.setenv("VISCOIN_SYNTH_N", "12")
    monkeypatch.setenv("VISCOIN_SYNTH_SIZE", "32")
    monkeypatch.chdir(tmp_path)
    torch.jit.trace(TinyDetector(), torch.zeros(1, 3, 8, 8)).save("tiny.pt")
    return tmp_path


def run_fid(args, capsys) -> dict:
    capsys.readouterr()
    assert main(["fid", "--device", "cpu", *args]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def features(gan_path, dataset, samples, batch, seed, **ds_kwargs):
    """The command's two feature sets, computed here step by step."""
    detect = make_torchscript_fid_detector("tiny.pt", "cpu")
    fake_fn, real_fn = tgan.make_gan_fid_fns(batch)
    train_ds, _ = get_datasets(dataset, "gan", train_only=True, **ds_kwargs)
    real = tgan.accumulate_real_fid_stats(detect, real_fn, train_ds, batch, samples,
                                          capture_all=True, device="cpu")
    fake = tgan.accumulate_fake_fid_stats(detect, fake_fn, load_generator(gan_path, "cpu"),
                                          seed, samples, capture_all=True)
    return real.get_all(), fake.get_all()


def jax_stats(x: np.ndarray) -> JF.FeatureStats:
    stats = JF.FeatureStats(capture_all=True)
    stats.append(x)
    return stats


def test_fid_kid_pr_match_eval_fid(gan_path, work, capsys):
    """FID, KID (seeded by --seed) and precision/recall of 8 samples per side
    in batches of 4: the printed values equal JAX's eval/fid.py on the same
    features (the matrix square root and the subset draws included)."""
    out = run_fid(["--gan", gan_path, "--dataset", "synthetic", "--samples", "8",
                   "--batch-size", "4", "--seed", "2", "--fid-detector", "tiny.pt",
                   "--metric", "fid", "--metric", "kid", "--metric", "pr"], capsys)
    real, fake = features(gan_path, "synthetic", 8, 4, 2)
    assert real.shape == fake.shape == (8, 12) and out["real_items"] == 8
    r, f = jax_stats(real), jax_stats(fake)
    want = {"fid": JF.fid_from_stats(r, f), "kid": JF.kid_from_stats(r, f, seed=2)}
    want["precision"], want["recall"] = JF.pr_from_stats(r, f)
    for k, v in want.items():
        assert out[k] == pytest.approx(v, rel=1e-9, abs=1e-12), (k, out[k], v)
    assert (out["samples"], out["dataset"], out["gan"]) == (8, "synthetic", gan_path)
    assert set(run_fid(["--gan", gan_path, "--dataset", "synthetic", "--samples", "8",
                        "--batch-size", "4", "--fid-detector", "tiny.pt"], capsys)) == {
        "fid", "real_items", "samples", "dataset", "gan"}


def test_real_side_from_a_zip_equals_its_folder(gan_path, work, monkeypatch, capsys):
    """A folder dataset (train/<class>/ images of several sizes) packed at
    32² by dataset-tool: the real-side features from the zip equal those
    from the folder decoded at the generator's resolution through the
    loader's PIL path, the geometry dataset-tool packs with (resize the
    short side, then crop). The loader's native path crops the short side's
    square first, then resizes: on a non-square image that samples half a
    pixel elsewhere, so it is not compared here. The command reads the zip."""
    from viscoin_tpu_torch import native

    rng = np.random.default_rng(3)
    for i in range(8):
        os.makedirs(f"birds/train/c{i % 2}", exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (32 + 3 * i, 40 - i, 3), np.uint8)).save(
            f"birds/train/c{i % 2}/{i}.png")
    assert main(["dataset-tool", "--source", "birds/train", "--dest", "birds.zip",
                 "--resolution", "32"]) == 0
    from_zip = features(gan_path, "birds.zip", 8, 4, 0, out_size=32)[0]
    monkeypatch.setattr(native, "available", lambda: False)
    from_folder = features(gan_path, "birds", 8, 4, 0, out_size=32)[0]
    np.testing.assert_array_equal(from_zip, from_folder)
    out = run_fid(["--gan", gan_path, "--samples", "8", "--batch-size", "4", "--fid-detector",
                   "tiny.pt", "--dataset", "birds.zip"], capsys)
    assert out["real_items"] == 8 and np.isfinite(out["fid"])


@pytest.mark.parametrize("case", ["resolution", "small", "samples", "detector"])
def test_refusals(gan_path, work, monkeypatch, capsys, case):
    """The JAX command's refusals, as usage errors (exit 2): a dataset at
    another resolution, fewer images than --batch-size, --samples 0, no
    detector."""
    args = ["fid", "--device", "cpu", "--gan", gan_path, "--dataset", "synthetic",
            "--samples", "8", "--batch-size", "4", "--fid-detector", "tiny.pt"]
    if case == "resolution":
        monkeypatch.setenv("VISCOIN_SYNTH_SIZE", "16")
        match = "decodes at 16² but the generator is 32²"
    elif case == "small":
        args[args.index("--batch-size") + 1] = "16"
        match = "dataset has 12 images < --batch-size 16"
    elif case == "samples":
        args[args.index("--samples") + 1] = "0"
        match = "--samples 0: need at least 1"
    else:
        args = args[:-2]
        match = "no FID detector at checkpoints/inception"
    capsys.readouterr()
    with pytest.raises(SystemExit) as done:
        main(args)
    assert done.value.code == 2 and match in capsys.readouterr().err


def test_ppl_metric(gan_path, work, capsys):
    """--metric ppl: without LPIPS weights a usage error; with them (at the
    default path) the value of compute_ppl on the loaded generator; with a
    TorchScript vgg16.pt that of compute_ppl_torchscript. No dataset or
    detector is read."""
    args = ["--gan", gan_path, "--dataset", "synthetic", "--samples", "6", "--batch-size", "4",
            "--seed", "5", "--metric", "ppl"]
    with pytest.raises(SystemExit) as done:
        main(["fid", "--device", "cpu", *args])
    assert done.value.code == 2 and "port-weights lpips" in capsys.readouterr().err
    lpips = init_models(LPIPS(device="cpu"), 4).eval().requires_grad_(False)
    ckpt.save_pytree(module_to_jax_tree(lpips)["params"], "checkpoints/lpips-vgg")
    ckpt.wait_for_saves()
    out = run_fid(args, capsys)
    g = load_generator(gan_path, "cpu")
    assert set(out) == {"ppl", "samples", "dataset", "gan"}
    assert out["ppl"] == TP.compute_ppl(g, lpips, 6, 4, seed=5) and out["ppl"] > 0
    _save_fake_vgg16_pt("vgg16.pt")
    out = run_fid([*args, "--lpips-detector", "vgg16.pt", "--ppl-sampling", "full"], capsys)
    assert out["ppl"] == TP.compute_ppl_torchscript(g, "vgg16.pt", 6, 4, seed=5,
                                                    sampling="full")
