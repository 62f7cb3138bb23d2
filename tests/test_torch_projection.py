"""``viscoin_tpu_torch/eval/projection.py`` and ``python -m viscoin_tpu_torch
project`` against the JAX package's ``viscoin_tpu/eval/projection.py`` at toy
widths (z 8, w 16, 32², 2 mapping layers; full-width LPIPS-VGG on 32²
images): the noise penalty and renormalisation, then 5 steps of
``make_projector`` with JAX's random numbers (its w_avg latents, initial
noise buffers and per-step exploration noise, rebuilt from its keys) with
the noise optimisation on and off and ``w_plus`` on and off: w, the noise
buffers and the losses against JAX's."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from torch_port_helpers import jax_generator, one_torch_thread, perturb, run_once  # noqa: F401
from torch_port_helpers import save_generator
from viscoin_tpu.eval import projection as JPJ
from viscoin_tpu.models.lpips import LPIPS
from viscoin_tpu.models.stylegan import num_ws_for_resolution
from viscoin_tpu_torch.__main__ import main
from viscoin_tpu_torch.eval import projection as TPJ
from viscoin_tpu_torch.models.lpips import LPIPS as TLPIPS
from viscoin_tpu_torch.utils import checkpoints as ckpt
from viscoin_tpu_torch.utils.weights import load_jax_tree

STEPS, SAMPLES = 5, 64
NUM_WS = num_ws_for_resolution(32)
# |port - reference| / max |reference| per tensor (w, each noise buffer, the
# losses) after five Adam steps. Adam divides each component's gradient by
# its own running RMS, so a component with a small gradient carries that
# gradient's relative rounding into a full-size update: in the W+ cases (a w
# per layer) the port's fp32 w lies 2.8e-4 from its float64 run, JAX's 8e-4;
# one w shared by the layers, and the noise buffers and losses, lie within
# 3e-5 (CPU). Against the float64 run, the port's fp32 rounding; against
# JAX, also JAX's.
ORACLE_TOL = 1e-3
JAX_TOL = 2e-3


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    g, gvars = jax_generator(seed=6)
    x = jnp.zeros((1, 32, 32, 3))
    lp = jax.tree_util.tree_map(np.asarray, perturb(
        run_once(LPIPS().init, jax.random.PRNGKey(7), x, x)["params"], 8))
    root = tmp_path_factory.mktemp("proj")
    path = save_generator(gvars, str(root / "gan-toy"))
    from viscoin_tpu_torch.cli.utils import load_generator

    tg = load_generator(path, "cpu")
    tl = load_jax_tree(TLPIPS(device="cpu"), {"params": lp}).eval().requires_grad_(False)
    target = np.asarray(g.apply(gvars, jnp.asarray(
        np.random.default_rng(1).standard_normal((1, 8)), jnp.float32), noise_mode="const"))
    return dict(g=g, gvars=gvars, lp=lp, tg=tg, tl=tl, root=root, path=path,
                target=np.clip(target + 0.05, -1, 1))


def port_name(path) -> str:
    """A JAX noise leaf's path -> the buffer's name under ``synthesis``."""
    return ".".join(k.key for k in path[1:])


def jax_draws(gvars, key, w_plus: bool) -> TPJ.ProjectionDraws:
    """The random numbers JAX's ``project`` draws from ``key``."""
    kz, knoise, kscan = jax.random.split(key, 3)
    z = jax.random.normal(kz, (SAMPLES, 8))
    leaves = jax.tree_util.tree_flatten_with_path(gvars["noise"])[0]
    keys = jax.random.split(knoise, len(leaves))
    noise = {port_name(p): torch.tensor(np.asarray(jax.random.normal(k, n.shape)))
             for (p, n), k in zip(leaves, keys)}
    rows = NUM_WS if w_plus else 1
    steps = jnp.stack([jax.random.normal(jax.random.fold_in(kscan, i), (rows, 16))
                       for i in range(STEPS)])
    return TPJ.ProjectionDraws(torch.tensor(np.asarray(z)), noise,
                               torch.tensor(np.asarray(steps)))


def rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30))


def test_noise_regularization_matches_jax():
    rng = np.random.default_rng(0)
    for res in (4, 8, 32, 64):
        n = rng.standard_normal((res, res)).astype(np.float32)
        n[:, 1:] += 0.3 * n[:, :-1]  # correlated, so every term is live
        got = float(TPJ.noise_regularization(torch.from_numpy(n)))
        want = float(JPJ.noise_regularization(jnp.asarray(n)))
        assert abs(got - want) <= 1e-5 * want, (res, got, want)


def test_normalize_noise_matches_jax():
    rng = np.random.default_rng(1)
    bufs = {f"b{r}": (3.0 * rng.standard_normal((r, r)) + 1.5).astype(np.float32)
            for r in (4, 16)}
    got = TPJ._normalize_noise({k: torch.from_numpy(v) for k, v in bufs.items()})
    want = JPJ._normalize_noise({k: jnp.asarray(v) for k, v in bufs.items()})
    for k in bufs:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6)
        assert abs(float(got[k].mean())) < 1e-6 and abs(float(got[k].square().mean()) - 1) < 1e-5


def zero_strengths(gvars: dict) -> dict:
    """The variables with every synthesis noise strength 0 (the buffers
    then leave the image, and JAX's drift of them, ROADMAP.md §3, the
    loss)."""
    out = jax.tree_util.tree_map(lambda x: x, gvars)
    for block in out["params"]["synthesis"].values():
        for layer in block.values():
            if isinstance(layer, dict) and "noise_strength" in layer:
                layer["noise_strength"] = np.zeros_like(layer["noise_strength"])
    return out


def run_port(nets, tg, target, draws, kw, dtype=torch.float32):
    tg.to(dtype), nets["tl"].to(dtype)
    try:
        draws = TPJ.ProjectionDraws(draws.z.to(dtype), {k: v.to(dtype) for k, v in
                                                         draws.noise.items()},
                                    draws.steps.to(dtype))
        w, noise, losses = TPJ.make_projector(tg, nets["tl"], **kw)(target.to(dtype), draws)
        return w.float(), {k: n.float() for k, n in noise.items()}, losses.float()
    finally:
        tg.float(), nets["tl"].float()


@pytest.mark.parametrize("w_plus", [False, True])
@pytest.mark.parametrize("optimize_noise", [True, False])
def test_projector_matches_jax(nets, w_plus, optimize_noise):
    """5 steps, w_avg from 64 draws, JAX's draws: w, every noise buffer and
    the 5 losses within ORACLE_TOL of the port's float64 run (the synthesis,
    LPIPS and Adam in float64; the mapping and the style affines compute in
    fp32 in both) and within JAX_TOL of JAX. Without the noise optimisation
    the buffers come back as the generator's own, and JAX is compared on
    the variables with the noise strengths zeroed: JAX moves the buffers
    there (ROADMAP.md §3), which then leaves w and the loss alone."""
    g, gvars, tg = nets["g"], nets["gvars"], nets["tg"]
    if not optimize_noise:
        from viscoin_tpu_torch.cli.port_weights import generator_from_tree

        gvars = zero_strengths(gvars)
        tg = generator_from_tree(gvars, "cpu").eval().requires_grad_(False)
    key = jax.random.PRNGKey(21)
    kw = dict(num_steps=STEPS, w_plus=w_plus, optimize_noise=optimize_noise)
    jw, jnoise, jlosses = JPJ.make_projector(g, LPIPS(), w_avg_samples=SAMPLES, **kw)(
        gvars, nets["lp"], jnp.asarray(nets["target"]), key)
    target = torch.from_numpy(np.ascontiguousarray(nets["target"].transpose(0, 3, 1, 2)))
    draws = jax_draws(gvars, key, w_plus)
    w, noise, losses = run_port(nets, tg, target, draws, kw)
    w64, noise64, losses64 = run_port(nets, tg, target, draws, kw, torch.float64)
    assert w.shape == (NUM_WS, 16) and losses.shape == (STEPS,)
    devs = {"w": (rel(w, w64), rel(w, jw)), "losses": (rel(losses, losses64), rel(losses, jlosses))}
    for p, n in jax.tree_util.tree_flatten_with_path(jnoise)[0]:
        name = port_name(p)
        if optimize_noise:
            devs[name] = (rel(noise[name], noise64[name]), rel(noise[name], n))
        else:  # the generator's own buffers, untouched
            assert torch.equal(noise[name], tg.synthesis.get_buffer(name))
    for name, (oracle, jax_dev) in devs.items():
        assert oracle <= ORACLE_TOL and jax_dev <= JAX_TOL, (name, oracle, jax_dev)
    assert (w[0] != w[-1]).any() == w_plus


def test_projection_without_noise_keeps_the_buffers_jax_moves_them(nets):
    """The fault of ROADMAP.md §3: with optimize_noise=False the JAX
    projector still applies Adam to the noise buffers (its docstring says
    they come back untouched); the port keeps them. The size of JAX's
    drift is asserted, as a record."""
    g, gvars = nets["g"], nets["gvars"]
    _, jnoise, _ = JPJ.make_projector(g, LPIPS(), num_steps=STEPS, w_avg_samples=SAMPLES,
                                      optimize_noise=False)(
        gvars, nets["lp"], jnp.asarray(nets["target"]), jax.random.PRNGKey(21))
    drift = max(rel(n, gvars["noise"]["synthesis"][p[1].key][p[2].key]["noise_const"])
                for p, n in jax.tree_util.tree_flatten_with_path(jnoise)[0])
    assert drift > 0.01, drift


def test_draws_and_render(nets):
    tg = nets["tg"]
    d = TPJ.draw_projection(tg, 3, w_plus=True, w_avg_samples=8, seed=4)
    again = TPJ.draw_projection(tg, 3, w_plus=True, w_avg_samples=8, seed=4)
    assert d.z.shape == (8, 8) and d.steps.shape == (3, NUM_WS, 16)
    assert set(d.noise) == set(TPJ.noise_buffer_names(tg)) and len(d.noise) == 7
    assert torch.equal(d.z, again.z) and torch.equal(d.steps, again.steps)
    assert not torch.equal(TPJ.draw_projection(tg, 3, seed=5).z[:8], d.z)
    w = tg.mapping(d.z[:1])[0]
    noise = dict(tg.synthesis.named_buffers())
    torch.testing.assert_close(TPJ.render(tg, w, noise), tg.synthesis(w[None],
                                                                       noise_mode="const"))


def test_project_command(nets, tmp_path, monkeypatch, capsys):
    """In-process: without LPIPS weights a usage error naming `port-weights
    lpips`; with them, --steps 4 writes proj.png, target.png (the target at
    the generator's resolution) and projected_w.npz (w, losses)."""
    monkeypatch.chdir(tmp_path)
    Image.fromarray(np.random.default_rng(2).integers(0, 256, (40, 50, 3), np.uint8)).save(
        "bird.png")
    args = ["project", "--gan", nets["path"], "--target", "bird.png", "--steps", "4",
            "--device", "cpu"]
    with pytest.raises(SystemExit) as done:
        main(args)
    assert done.value.code == 2 and "port-weights lpips" in capsys.readouterr().err
    ckpt.save_pytree(nets["lp"], "checkpoints/lpips-vgg")
    ckpt.wait_for_saves()
    assert main([*args, "--w-plus"]) == 0
    assert "projected in 4 steps" in capsys.readouterr().out
    out = np.load("proj/projected_w.npz")
    assert set(out.files) == {"w", "losses"} and out["w"].shape == (NUM_WS, 16)
    assert out["losses"].shape == (4,) and np.isfinite(out["losses"]).all()
    assert not np.array_equal(out["w"][0], out["w"][1])  # W+: a w per layer
    for name in ("proj.png", "target.png"):
        assert np.asarray(Image.open(os.path.join("proj", name))).shape == (32, 32, 3)
