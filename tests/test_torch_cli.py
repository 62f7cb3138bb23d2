"""``python -m viscoin_tpu_torch train viscoin`` on the CPU: the JAX command's
options and defaults; the flagship modules it builds, against the JAX
command's builder; a run at the JAX CLI tests' data size (8 synthetic
images at 32²) and its resume, with the jsonl keys of the JAX loop and the
bundle and training state on disk (toy widths: the suite runs several test
processes at once, and ``chip_smoke.py`` runs the command at full width on
the card); and the options that are not ported, which raise and name the
ROADMAP queue."""

import json
import os
import runpy
import shutil
import subprocess
import sys
import warnings
from dataclasses import fields
from pathlib import Path

import click
import numpy as np
import pytest
import torch

from torch_port_helpers import CLASSIFIER, GAN, NK, PSI
from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from viscoin_tpu.cli.train import train as jax_train
from viscoin_tpu.models.bundle import default_models as jax_default_models
from viscoin_tpu.utils import checkpoints as jckpt
from viscoin_tpu.utils.types import TestingResults as JTestingResults
from viscoin_tpu.utils.types import TrainingResults as JTrainingResults
from viscoin_tpu_torch.__main__ import build_parser, main
from viscoin_tpu_torch.cli import train as cli_train
from viscoin_tpu_torch.models import bundle as tb
from viscoin_tpu_torch.models.concept_extractor import ConceptExtractor
from viscoin_tpu_torch.models.explainer import Explainer
from viscoin_tpu_torch.models.lpips import LPIPS
from viscoin_tpu_torch.models.resnet import Classifier
from viscoin_tpu_torch.models.stylegan import Generator, GeneratorAdapted
from viscoin_tpu_torch.utils import checkpoints as ckpt

REPO = Path(__file__).resolve().parent.parent
# The JAX `train` command's options that apply to the viscoin model.
VISCOIN_OPTIONS = {
    "batch_size", "device", "dataset", "epochs", "learning_rate", "output_weights",
    "checkpoints", "gradient_accumulation_steps", "data_parallel", "model_parallel",
    "compute_dtype", "debug_nans", "resume_from", "profile_dir", "fid_detector_path",
    "image_size", "eval_every", "checkpoint_every", "faithfulness_every", "prefetch",
}


def test_options_and_defaults_match_the_jax_command():
    """Same option names and defaults as `main.py train viscoin`, except the
    device, which is a torch device ("cuda") instead of a JAX platform."""
    jax_params = {p.name: p for p in jax_train.params if isinstance(p, click.Option)}
    assert VISCOIN_OPTIONS <= set(jax_params)
    ctx = click.Context(jax_train)
    unset = getattr(getattr(click, "_utils", None), "UNSET", None)  # click >= 8.2: no default

    def default(name):
        value = jax_params[name].get_default(ctx)
        return None if value is unset else value

    args = build_parser().parse_args(["train", "viscoin"])
    for name in VISCOIN_OPTIONS:
        assert hasattr(args, name), name
        if name != "device":
            assert getattr(args, name) == default(name), name
        assert set(jax_params[name].opts) <= set(
            build_parser()._subparsers._group_actions[0].choices["train"]
            ._option_string_actions), name
    assert args.device == "cuda" and args.compute_dtype == "bfloat16"
    assert args.prefetch is None and args.data_parallel is True
    no_dp = build_parser().parse_args(["train", "viscoin", "--no-data-parallel"])
    assert no_dp.data_parallel is False


TRAIN = ["train", "viscoin", "--device", "cpu", "--dataset", "synthetic", "--batch-size", "2",
         "--eval-every", "1", "--checkpoint-every", "5", "--faithfulness-every", "0"]


def test_build_viscoin_modules_is_the_jax_commands_flagship():
    """The ensemble the command builds has the JAX command's geometry
    (viscoin_tpu/cli/train.py::build_viscoin_modules): the same module
    config, the original generator z 512, w 512, 2 mapping layers at
    channel_base 16384, and LPIPS-VGG."""
    models, gen, lpips = cli_train.build_viscoin_modules(10, 32, device="cpu")
    want = jax_default_models(n_classes=10, img_resolution=32, channel_base=16384)
    as_json = [json.loads(json.dumps(c)) for c in (ckpt.module_config(models),
                                                    jckpt._module_config(want))]
    assert as_json[0] == as_json[1]
    assert (gen.z_dim, gen.mapping.w_dim, gen.mapping.num_layers) == (512, 512, 2)
    assert (gen.synthesis.img_resolution, gen.synthesis.channel_base) == (32, 16384)
    assert isinstance(lpips, LPIPS) and next(models.parameters()).device.type == "cpu"


def toy_modules(n_classes: int, size: int, device="cuda"):
    """``build_viscoin_modules`` at the toy widths of tests/torch_port_helpers.py."""
    models = tb.VisCoINModels(
        classifier=Classifier(**dict(CLASSIFIER, output_classes=n_classes), device=device),
        concept_extractor=ConceptExtractor(**PSI, device=device),
        explainer=Explainer(n_concepts=NK, n_classes=n_classes, device=device),
        gan=GeneratorAdapted(**dict(GAN, img_resolution=size), device=device))
    generator = Generator(z_dim=16, w_dim=32, img_resolution=size, channel_base=256,
                          channel_max=16, mapping_layers=2, device=device)
    return (tb.init_models(models, 0), tb.init_models(generator, 1),
            tb.init_models(LPIPS(device=device), 2))


def test_python_m_resolves_the_command():
    """`python -m viscoin_tpu_torch` in a fresh interpreter reaches the
    train command's parser."""
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-m", "viscoin_tpu_torch", "train", "--help"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "--gradient-accumulation-steps" in res.stdout and "--resume" in res.stdout


def test_train_viscoin_on_the_cpu_then_resume(tmp_path, monkeypatch, capsys):
    """In this process (a second interpreter would import torch again), at
    toy widths: `python -m viscoin_tpu_torch train viscoin` as runpy runs
    it, 1 iteration (eval, a checkpoint at i = 0), then main() with --resume
    to 2 (eval at i = 1): every jsonl record has the JAX loop's keys with
    finite values, the bundle loads, the state resumes at step 1."""
    monkeypatch.setattr(cli_train, "build_viscoin_modules", toy_modules)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("VISCOIN_SYNTH_N", "8")
    monkeypatch.setenv("VISCOIN_SYNTH_SIZE", "32")
    monkeypatch.setattr(sys, "argv", ["viscoin_tpu_torch", *TRAIN, "--epochs", "1"])
    try:
        with warnings.catch_warnings(), pytest.raises(SystemExit) as done:
            # runpy warns that this module's import (above) put it in sys.modules.
            warnings.simplefilter("ignore", RuntimeWarning)
            runpy.run_module("viscoin_tpu_torch", run_name="__main__", alter_sys=True)
        assert done.value.code == 0
        assert "WARNING: classifier checkpoint" in capsys.readouterr().out
        assert {"viscoin0-0", "train_state", "viscoin_1.jsonl"} <= set(os.listdir(tmp_path))
        bundle = ckpt.load_viscoin_bundle(str(tmp_path / "viscoin0-0"), device="cpu")
        assert bundle.gan.img_resolution == 32 and bundle.classifier.config["output_classes"] == 10
        del bundle
        saved = torch.load(tmp_path / "train_state" / "train_state.pt", weights_only=True)
        assert saved["step"] == 1
        with open(tmp_path / "train_state" / "train_state_meta.json") as f:
            assert json.load(f)["compute_dtype"] == "bfloat16"
        assert main([*TRAIN, "--epochs", "2", "--resume", "train_state"]) == 0
        want = {f"train_{f.name}" for f in fields(JTrainingResults)} | {
            f"test_{f.name}" for f in fields(JTestingResults)}
        for log, n in (("viscoin_1.jsonl", 1), ("viscoin_2.jsonl", 1)):
            with open(tmp_path / log) as f:
                recs = [json.loads(line) for line in f]
            assert len(recs) == n, log
            for rec in recs:
                assert set(rec) == want
                assert all(np.isfinite(v) for k, v in rec.items() if k != "test_fid_score")
    finally:
        for name in ("viscoin0-0", "train_state"):
            shutil.rmtree(tmp_path / name, ignore_errors=True)


@pytest.mark.parametrize("argv, error, match", [
    # Ported: one process on the CPU is one device, which 2 does not divide
    # (the JAX command's words). The id is the one of the case that expected
    # the refusal of the unported option.
    pytest.param(["--model-parallel", "2"], ValueError,
                 r"--model-parallel=2 does not divide the 1 available devices",
                 id="argv0-NotImplementedError-model-parallel.*ROADMAP"),
    # FunnyBirds is ported: the command reaches its loader, which names where
    # it looked for the files.
    (["--dataset", "funnybirds"], FileNotFoundError, "FunnyBirds not found"),
])
def test_unported_options_raise(argv, error, match, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the jsonl log opens before the dataset raises
    monkeypatch.setenv("VISCOIN_DATA_DIR", str(tmp_path))
    with pytest.raises(error, match=match):
        main(["train", "viscoin", "--device", "cpu", "--dataset", "synthetic", *argv])


@pytest.mark.parametrize("model", ["concept2clip"])
def test_unported_models_raise(model, tmp_path, monkeypatch):
    """`train concept2clip` (ported) without a bundle raises the JAX
    command's error; an unknown model name raises."""
    from viscoin_tpu.cli.train import _train_concept2clip as jax_train_concept2clip

    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError) as want:
        jax_train_concept2clip("viscoin", "synthetic", 1, None, None, "out")
    with pytest.raises(FileNotFoundError) as got:
        main(["train", model, "--device", "cpu", "--dataset", "synthetic"])
    assert str(got.value) == str(want.value)
    assert "checkpoints/synthetic/viscoin-synthetic" in str(got.value)
    assert not os.path.exists("out") and not os.path.exists("output-weights")
    with pytest.raises(ValueError, match="Unknown model"):
        main(["train", "resnet", "--device", "cpu"])


def test_data_parallel_over_several_cards_raises(monkeypatch):
    """With several visible cards and no torchrun group, --data-parallel
    starts one worker process per card (the spawn itself is stubbed here);
    under torchrun the command joins its group instead, and
    --no-data-parallel there raises; the --image-size check still raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    spawned = []
    monkeypatch.setattr(cli_train, "_spawn", lambda args, n: spawned.append((args, n)))
    main(["train", "viscoin", "--dataset", "synthetic"])
    (args, n), = spawned
    assert n == 2 and args.model_name == "viscoin" and args.device == "cuda"
    assert cli_train._spawned_workers(torch.device("cuda"), False, 1) == 0
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert cli_train._spawned_workers(torch.device("cuda"), True, 1) == 0
    with pytest.raises(ValueError, match="--no-data-parallel in a group of 2"):
        cli_train._build_mesh(torch.device("cpu"), False)
    monkeypatch.delenv("WORLD_SIZE")
    assert cli_train._build_mesh(torch.device("cpu"), True) is None
    with pytest.raises(ValueError, match="--image-size applies"):
        main(["train", "viscoin", "--dataset", "synthetic", "--image-size", "64",
              "--no-data-parallel", "--device", "cpu"])
