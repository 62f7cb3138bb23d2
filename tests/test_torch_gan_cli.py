"""``python -m viscoin_tpu_torch train gan`` on the CPU at toy widths (16²,
8 synthetic images, batch 4): the JAX command's options and defaults; the
full-width modules the real `build_gan_modules` makes, against the JAX command's; a run
with checkpoints and snapshots and its resume, bit-exact against the
unbroken run; the warm start; the export, read back by ``train viscoin``'s
loader and by the JAX package; and the options that are not ported."""

import json
import os

import click
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from viscoin_tpu.cli.train import build_gan_modules as jax_build_gan_modules
from viscoin_tpu.cli.train import train as jax_train
from viscoin_tpu.models.stylegan import Generator as JGenerator
from viscoin_tpu.utils import checkpoints as jckpt
from viscoin_tpu_torch.__main__ import build_parser, main
from viscoin_tpu_torch.cli import train as cli_train
from viscoin_tpu_torch.models import bundle as tb
from viscoin_tpu_torch.models.stylegan import Discriminator, Generator
from viscoin_tpu_torch.train import gan as tgan
from viscoin_tpu_torch.utils import checkpoints as ckpt
from viscoin_tpu_torch.utils.weights import load_jax_tree, module_to_jax_tree

# The JAX `train` command's options that apply to the gan model.
GAN_OPTIONS = {
    "batch_size", "device", "dataset", "epochs", "learning_rate", "output_weights",
    "data_parallel", "model_parallel", "compute_dtype", "resume_from", "channel_base",
    "channel_max", "fid_every", "fid_samples", "fid_detector_path", "init_from", "ema_rampup",
    "mirror",
    "image_size", "snapshot_every", "checkpoint_every", "prefetch",
}
TOY_G = dict(z_dim=8, w_dim=16, channel_base=256, channel_max=16, mapping_layers=1)


def toy_gan_modules(size, channel_base, channel_max, batch_size, device="cuda", seed=0):
    """``build_gan_modules`` at toy widths."""
    g = Generator(img_resolution=size, **TOY_G, device=device)
    d = Discriminator(img_resolution=size, channel_base=256, channel_max=16,
                      mbstd_group_size=min(4, batch_size), device=device)
    return tb.init_models(g, seed), tb.init_models(d, seed + 1)


def test_gan_options_and_defaults_match_the_jax_command():
    """Same option names and defaults as `main.py train gan`, except the
    device (a torch device, "cuda")."""
    jax_params = {p.name: p for p in jax_train.params if isinstance(p, click.Option)}
    assert GAN_OPTIONS <= set(jax_params)
    ctx = click.Context(jax_train)
    unset = getattr(getattr(click, "_utils", None), "UNSET", None)
    args = build_parser().parse_args(["train", "gan"])
    actions = build_parser()._subparsers._group_actions[0].choices["train"]._option_string_actions
    for name in GAN_OPTIONS:
        value = jax_params[name].get_default(ctx)
        if name != "device":
            assert getattr(args, name) == (None if value is unset else value), name
        assert set(jax_params[name].opts) <= set(actions), name
    assert (args.channel_base, args.channel_max, args.fid_every, args.mirror) == (
        16384, 512, 0, True)
    assert build_parser().parse_args(["train", "gan", "--no-mirror"]).mirror is False


def test_build_gan_modules_is_the_jax_commands_gan(monkeypatch):
    """The real `build_gan_modules`' generator and discriminator have the JAX command's
    full-width config (viscoin_tpu/cli/train.py::build_gan_modules): 256²,
    z = w = 512, 2 mapping layers, channel_base 16384, channel_max 512,
    mbstd group min(4, batch). Built on the meta device (no weights)."""
    monkeypatch.setattr(tb, "init_models", lambda m, seed=0: m)
    g, d = cli_train.build_gan_modules(256, 16384, 512, 16, device="meta")
    jg, jd = jax_build_gan_modules(256, 16384, 512, 16)
    for key, value in g.config.items():
        assert getattr(jg, key) == value, key
    for key, value in d.config.items():
        assert getattr(jd, key) == value, key
    assert g.config["mapping_layers"] == 2 and d.config["mbstd_group_size"] == 4
    assert sum(p.numel() for p in g.parameters()) > 2e7
    assert cli_train.build_gan_modules(256, 16384, 512, 2, device="meta")[1].config[
        "mbstd_group_size"] == 2


BASE = ["train", "gan", "--device", "cpu", "--dataset", "synthetic", "--batch-size", "4",
        "--compute-dtype", "float32"]


@pytest.fixture
def toy_cli(tmp_path, monkeypatch):
    monkeypatch.setattr(cli_train, "build_gan_modules", toy_gan_modules)
    monkeypatch.setenv("VISCOIN_SYNTH_N", "8")
    monkeypatch.setenv("VISCOIN_SYNTH_SIZE", "16")
    return tmp_path


def _state(path) -> dict:
    return torch.load(os.path.join(path, "train_state.pt"), weights_only=True)


def _assert_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            _assert_equal(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def test_train_gan_checkpoint_resume_is_bit_exact(toy_cli, monkeypatch):
    """2 iterations (a checkpoint at i = 1, snapshots at 0 and 1), then a
    resume to 3 (R1 and PPL on at step 0, the loader fast-forwarded, the
    draws from (seed, step)): the whole training state equals that of an
    unbroken 3-iteration run bit for bit; the jsonl records carry every
    metric, finite."""
    for sub in ("a", "b"):
        os.makedirs(toy_cli / sub)
    monkeypatch.chdir(toy_cli / "a")
    assert main([*BASE, "--epochs", "2", "--checkpoint-every", "1", "--snapshot-every", "1",
                 "--output-weights", "gan"]) == 0
    assert {"gan", "gan.train_state", "gan_2.jsonl", "fakes_000000.png",
            "fakes_000001.png"} <= set(os.listdir("."))
    with open("gan.train_state/train_state_meta.json") as f:
        assert json.load(f) == {"batch_size": 4, "seed": 0, "augment": "ada",
                                "compute_dtype": "float32", "mirror": True, "ema_rampup": 0.0}
    assert main([*BASE, "--epochs", "3", "--resume", "gan.train_state",
                 "--output-weights", "gan"]) == 0
    monkeypatch.chdir(toy_cli / "b")
    assert main([*BASE, "--epochs", "3", "--output-weights", "gan"]) == 0
    resumed, unbroken = _state(toy_cli / "a" / "gan.train_state"), _state("gan.train_state")
    assert resumed["step"] == unbroken["step"] == 3
    _assert_equal(resumed, unbroken)
    with open("gan_3.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["iteration"] for r in recs] == [0, 2]
    assert set(recs[0]) == {"iteration", "g_loss", "d_loss", "r1", "pl_lengths", "pl_mean",
                            "ada_p", "ada_rt"}
    assert recs[0]["r1"] > 0 and recs[0]["pl_lengths"] > 0
    assert all(np.isfinite(v) for r in recs for v in r.values())


def test_export_is_read_by_train_viscoin_and_by_jax(toy_cli, monkeypatch):
    """The exported EMA generator (npz layout, with the tracked w_avg) loads
    into a Generator as `train viscoin` loads checkpoints/<dataset>/gan-<dataset>,
    equal to the EMA module; JAX's restore_pytree reads the same tree, and
    the JAX Generator on it synthesises what the port's does."""
    monkeypatch.chdir(toy_cli)
    assert main([*BASE, "--epochs", "1", "--output-weights", "checkpoints/synthetic/"
                 "gan-synthetic"]) == 0
    path = "checkpoints/synthetic/gan-synthetic"
    assert path == cli_train.default_checkpoints("synthetic")["gan"]
    tree = ckpt.restore_pytree(path)
    assert set(tree) == {"params", "noise", "moving_stats"}
    g = load_jax_tree(Generator(img_resolution=16, **TOY_G, device="cpu"), tree)
    saved = _state("checkpoints/synthetic/gan-synthetic.train_state")
    for name, value in saved["g_ema"].items():
        if name != "mapping.w_avg":
            assert torch.equal(g.state_dict()[name], value), name
    assert torch.equal(g.mapping.w_avg, saved["w_avg"]) and bool(saved["w_avg"].any())
    jtree = jckpt.restore_pytree(path)
    z = np.random.default_rng(0).standard_normal((2, 8)).astype(np.float32)
    want = JGenerator(img_resolution=16, **TOY_G).apply(jtree, jnp.asarray(z),
                                                        truncation_psi=0.5, noise_mode="const")
    with torch.no_grad():
        got = g(torch.from_numpy(z), truncation_psi=0.5, noise_mode="const")
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-5)


def test_init_from_warm_starts_a_fresh_run(toy_cli, monkeypatch, capsys):
    """--init-from loads an export into both the generator and its EMA,
    with its w_avg, and the discriminator from <path>.discriminator when
    present; the step, optimizers and ADA start over. A config mismatch and
    mixing it with --resume raise."""
    monkeypatch.chdir(toy_cli)
    assert main([*BASE, "--epochs", "1", "--output-weights", "src"]) == 0
    tree = ckpt.restore_pytree("src")
    cfg = tgan.GANTrainingParams(batch_size=4)
    g, d = toy_gan_modules(16, 0, 0, 4, device="cpu", seed=5)
    state = tgan.create_gan_train_state(g, d, cfg)
    d_before = {k: v.clone() for k, v in d.state_dict().items()}
    tgan.warm_start_gan_state(state, tree)
    want = load_jax_tree(Generator(img_resolution=16, **TOY_G, device="cpu"), tree)
    for name, value in want.named_parameters():
        assert torch.equal(g.get_parameter(name), value)
        assert torch.equal(state.g_ema.get_parameter(name), value)
    assert torch.equal(state.w_avg, torch.from_numpy(tree["moving_stats"]["mapping"]["w_avg"]))
    _assert_equal(d.state_dict(), d_before)
    assert state.step == 0 and state.g_opt.state == {}

    wide = Generator(img_resolution=16, **dict(TOY_G, w_dim=32), device="cpu")
    other = tgan.create_gan_train_state(wide, toy_gan_modules(16, 0, 0, 4, device="cpu")[1], cfg)
    with pytest.raises(ValueError, match="channel config mismatch|does not match"):
        tgan.warm_start_gan_state(other, tree)

    assert main([*BASE, "--epochs", "1", "--init-from", "src", "--output-weights", "w"]) == 0
    assert "warm start from src (generator; fresh discriminator)" in capsys.readouterr().out
    ckpt.save_pytree(module_to_jax_tree(d)["params"], "src.discriminator")
    assert main([*BASE, "--epochs", "1", "--init-from", "src", "--output-weights", "w2"]) == 0
    assert "warm start from src (generator + discriminator)" in capsys.readouterr().out
    with pytest.raises(ValueError, match="pick one"):
        main([*BASE, "--epochs", "2", "--init-from", "src", "--resume", "w.train_state"])


def test_fid_every_is_a_usage_error(toy_cli, capsys):
    """--fid-every with no FID detector (no --fid-detector and no
    checkpoints/inception): a usage error naming it (exit code 2), before
    anything is built."""
    with pytest.raises(SystemExit) as done:
        main([*BASE, "--fid-every", "5"])
    assert done.value.code == 2
    assert "FID detector" in capsys.readouterr().err


def test_gan_data_parallel_over_several_cards_raises(monkeypatch):
    """Two visible cards: `train gan` starts a worker per card (stubbed
    here), with --model-parallel 2 too (the workers build the (1, 2) mesh);
    --model-parallel 2 without --data-parallel raises, as JAX's command."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    spawned = []
    monkeypatch.setattr(cli_train, "_spawn", lambda args, n: spawned.append((args, n)))
    main(["train", "gan", "--dataset", "synthetic"])
    (args, n), = spawned
    assert n == 2 and args.model_name == "gan" and args.model_parallel == 1
    main(["train", "gan", "--dataset", "synthetic", "--model-parallel", "2"])
    (args, n) = spawned[-1]
    assert n == 2 and args.model_name == "gan" and args.model_parallel == 2
    with pytest.raises(ValueError, match="requires --data-parallel"):
        main(["train", "gan", "--dataset", "synthetic", "--model-parallel", "2",
              "--no-data-parallel"])
