"""The port's GAN tools against the JAX package: ``parse_seeds``,
``generator_config_from_params`` (and the generator ``--gan`` loads), and the
``generate`` and ``style-mixing`` commands in-process at toy widths (z 8,
w 16, 32², 2 mapping layers), with the per-seed latents replaced by the same
seeded numpy values on both sides (the random streams differ by design,
PARITY.md divergence 7): images within one u8 level of JAX's
``Generator.apply`` on the same z, and the command's own structure (padded
batches, a full style mask, the grid)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from torch_port_helpers import TOY_GEN, jax_generator, one_torch_thread  # noqa: F401
from torch_port_helpers import save_generator
from viscoin_tpu.cli.generate import parse_seeds as jax_parse_seeds
from viscoin_tpu.models.stylegan import generator_config_from_params as jax_config
from viscoin_tpu.models.stylegan import num_ws_for_resolution
from viscoin_tpu_torch.__main__ import main
from viscoin_tpu_torch.cli import generate as gen_cmd
from viscoin_tpu_torch.cli import style_mixing as mix_cmd
from viscoin_tpu_torch.cli.utils import load_generator
from viscoin_tpu_torch.models.stylegan import generator_config_from_params

NUM_WS = num_ws_for_resolution(TOY_GEN["img_resolution"])
U8_TOL = 1  # u8 levels: fp32 synthesis in two frameworks, then truncation to uint8


@pytest.fixture(scope="module")
def jax_gan(tmp_path_factory):
    g, gvars = jax_generator(seed=3)
    path = save_generator(gvars, str(tmp_path_factory.mktemp("gan") / "gan-toy"))
    return g, gvars, path


def numpy_latents(seeds, z_dim):
    """The z both sides use in these tests: row i from numpy seeded seeds[i]."""
    return np.stack([np.random.default_rng(s).standard_normal(z_dim).astype(np.float32)
                     for s in seeds])


@pytest.fixture
def same_z(monkeypatch):
    fake = lambda seeds, z_dim: torch.from_numpy(numpy_latents(seeds, z_dim))  # noqa: E731
    monkeypatch.setattr(gen_cmd, "seed_latents", fake)
    monkeypatch.setattr(mix_cmd, "seed_latents", fake)


def jax_u8(img) -> np.ndarray:
    return np.asarray(jnp.clip((img + 1.0) * 127.5, 0.0, 255.0).astype(jnp.uint8))


def read_png(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"))


def test_parse_seeds_matches_jax():
    for spec in ("0-3,7,10-11", "5", " 2 , 4-4,", "9-12,1"):
        assert gen_cmd.parse_seeds(spec) == jax_parse_seeds(spec)
    for bad in ("", "a-b", "3-1", "1,,x", ","):
        with pytest.raises(Exception) as jax_err:
            jax_parse_seeds(bad, flag="--rows")
        with pytest.raises(ValueError) as err:
            gen_cmd.parse_seeds(bad, flag="--rows")
        assert str(err.value) == jax_err.value.format_message()


def test_generator_config_matches_jax(jax_gan):
    g, gvars, path = jax_gan
    assert generator_config_from_params(gvars["params"]) == jax_config(gvars["params"]) == {
        **TOY_GEN, "img_channels": 3}
    _, gray = jax_generator(seed=4, img_channels=1, channel_base=512, channel_max=8)
    assert generator_config_from_params(gray["params"]) == jax_config(gray["params"])
    bad = jax.tree_util.tree_map(lambda x: x, gvars["params"])
    bad["mapping"] = {"g1_w0": 0}
    for fn in (generator_config_from_params, jax_config):
        with pytest.raises(ValueError, match="no fc"):
            fn(bad)
    # the generator `--gan` loads: frozen, in eval mode, holding the variables
    tg = load_generator(path, "cpu")
    assert tg.config["img_channels"] == 3 and not tg.training
    assert not any(p.requires_grad for p in tg.parameters())
    np.testing.assert_array_equal(tg.mapping.w_avg.numpy(),
                                  gvars["moving_stats"]["mapping"]["w_avg"])


@pytest.mark.parametrize("psi", [1.0, 0.6])
def test_generate_matches_jax(jax_gan, same_z, tmp_path, monkeypatch, psi):
    """Seeds 0-5 in padded batches of 4 (the second batch ragged): each PNG
    within one u8 level of JAX's Generator.apply on the same z, with
    truncation through the exported w_avg."""
    g, gvars, path = jax_gan
    monkeypatch.chdir(tmp_path)
    assert main(["generate", "--gan", path, "--seeds", "0-5", "--batch-size", "4",
                 "--trunc", str(psi), "--device", "cpu"]) == 0
    want = jax_u8(g.apply(gvars, jnp.asarray(numpy_latents(range(6), 8)), truncation_psi=psi,
                          noise_mode="const"))
    for s in range(6):
        got = read_png(f"out/seed{s:04d}.png")
        assert got.shape == (32, 32, 3)
        assert np.abs(got.astype(int) - want[s]).max() <= U8_TOL, s


def test_generate_is_a_function_of_the_seed(jax_gan, tmp_path, monkeypatch):
    """Real latents: seed 3 alone equals seed 3 at another batch position,
    bit for bit (the CPU); noise-mode random runs; without --device the
    command asks for the card, which this machine lacks."""
    _, _, path = jax_gan
    monkeypatch.chdir(tmp_path)
    assert main(["generate", "--gan", path, "--seeds", "1-4", "--device", "cpu"]) == 0
    assert main(["generate", "--gan", path, "--seeds", "3", "--outdir", "one",
                 "--device", "cpu"]) == 0
    np.testing.assert_array_equal(read_png("out/seed0003.png"), read_png("one/seed0003.png"))
    z = gen_cmd.seed_latents([3, 3, 7], 8)
    assert torch.equal(z[0], z[1]) and not torch.equal(z[0], z[2])
    assert main(["generate", "--gan", path, "--seeds", "2", "--outdir", "rnd",
                 "--noise-mode", "random", "--device", "cpu"]) == 0
    assert read_png("rnd/seed0002.png").shape == (32, 32, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["generate", "--gan", path, "--seeds", "2"])
    with pytest.raises(SystemExit):
        main(["generate", "--gan", path, "--seeds", "3-1", "--device", "cpu"])


def test_style_mixing_matches_jax(jax_gan, same_z, tmp_path, monkeypatch):
    """Rows 85,100 x cols 55,821 with --col-styles 0-3 and --trunc 0.7:
    every cell within one u8 level of JAX's mapping (truncated), masked
    select and synthesis on the same z; the grid holds the cells, pure
    images on its top row and left column and a black corner."""
    g, gvars, path = jax_gan
    monkeypatch.chdir(tmp_path)
    rows, cols = [85, 100], [55, 821]
    assert main(["style-mixing", "--gan", path, "--rows", "85,100", "--cols", "55,821",
                 "--col-styles", "0-3", "--trunc", "0.7", "--batch-size", "3",
                 "--device", "cpu"]) == 0
    seeds = sorted(set(rows) | set(cols))
    ws = g.apply(gvars, jnp.asarray(numpy_latents(seeds, 8)), truncation_psi=0.7,
                 method=lambda mdl, z, **kw: mdl.mapping(z, **kw))
    mask = np.arange(NUM_WS) <= 3
    pairs = [(r, c) for r in rows for c in cols] + [(s, s) for s in rows + cols]
    ri = np.asarray([seeds.index(r) for r, _ in pairs])
    ci = np.asarray([seeds.index(c) for _, c in pairs])
    mixed = jnp.where(mask[None, :, None], ws[ci], ws[ri])
    want = jax_u8(g.apply(gvars, mixed, method=lambda mdl, w: mdl.synthesis(
        w, noise_mode="const")))
    for (r, c), img in zip(pairs, want):
        got = read_png(f"mix/{r}-{c}.png")
        assert np.abs(got.astype(int) - img).max() <= U8_TOL, (r, c)
    grid = read_png("mix/grid.png")
    assert grid.shape == (32 * 3, 32 * 3, 3) and not grid[:32, :32].any()
    np.testing.assert_array_equal(grid[32:64, 64:96], read_png("mix/85-821.png"))
    np.testing.assert_array_equal(grid[:32, 32:64], read_png("mix/55-55.png"))
    np.testing.assert_array_equal(grid[64:96, :32], read_png("mix/100-100.png"))


def test_style_mixing_full_mask_is_the_column_image(jax_gan, tmp_path, monkeypatch, capsys):
    """--col-styles over every layer: each cell (r, c) equals the column
    image (c, c) bit for bit; an out-of-range layer is a usage error."""
    _, _, path = jax_gan
    monkeypatch.chdir(tmp_path)
    assert main(["style-mixing", "--gan", path, "--rows", "1,2", "--cols", "3",
                 "--col-styles", f"0-{NUM_WS - 1}", "--device", "cpu"]) == 0
    for r in (1, 2):
        np.testing.assert_array_equal(read_png(f"mix/{r}-3.png"), read_png("mix/3-3.png"))
    assert not np.array_equal(read_png("mix/1-1.png"), read_png("mix/3-3.png"))
    with pytest.raises(SystemExit):
        main(["style-mixing", "--gan", path, "--col-styles", f"0-{NUM_WS}", "--device", "cpu"])
    assert "out of range" in capsys.readouterr().err
    assert sorted(os.listdir("mix")) == ["1-1.png", "1-3.png", "2-2.png", "2-3.png",
                                         "3-3.png", "grid.png"]


def test_synthesis_runs_under_deterministic_cudnn(jax_gan, tmp_path, monkeypatch):
    """generate and style-mixing synthesise with cuDNN's deterministic
    algorithms (the up-convs' default transposed-conv algorithms add with
    atomics on the card) and give the caller's setting back."""
    from viscoin_tpu_torch.models.stylegan import SynthesisNetwork

    _, _, path = jax_gan
    monkeypatch.chdir(tmp_path)
    seen = []
    forward = SynthesisNetwork.forward

    def spy(self, *a, **k):
        seen.append(torch.backends.cudnn.deterministic)
        return forward(self, *a, **k)

    monkeypatch.setattr(SynthesisNetwork, "forward", spy)
    torch.backends.cudnn.deterministic = False
    assert main(["generate", "--gan", path, "--seeds", "1", "--device", "cpu"]) == 0
    assert main(["style-mixing", "--gan", path, "--rows", "1", "--cols", "2",
                 "--device", "cpu"]) == 0
    assert seen == [True, True] and not torch.backends.cudnn.deterministic
