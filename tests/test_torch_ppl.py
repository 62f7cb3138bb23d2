"""``viscoin_tpu_torch/eval/ppl.py`` against the JAX package's
``viscoin_tpu/eval/ppl.py`` at toy widths (z 8, w 16, 32², 2 mapping
layers; full-width LPIPS-VGG on 32² images), with JAX's z endpoints and t
injected (the random streams differ by design, PARITY.md divergence 7).

At epsilon = 1e-4 the pair's features differ by about 1e-4 of their scale.
The JAX package takes the LPIPS distance in its one-pass form, whose fp32
channel sums cancel to rounding there; the port takes it in the
normalized-difference form (ROADMAP.md §3). So at 1e-4 the port is held to
a float64 run of itself (the same code on float64 modules and draws: the
synthesis and LPIPS in float64, the mapping and the style affines in fp32
as in either run) and JAX's gap to that oracle is measured beside it; at
epsilon = 1e-2, where the one-pass form is accurate, the port is held to JAX
itself."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_cli_fid import _save_fake_vgg16_pt
from torch_port_helpers import jax_generator, one_torch_thread, perturb, run_once  # noqa: F401
from viscoin_tpu.eval import ppl as JP
from viscoin_tpu.models.lpips import LPIPS
from viscoin_tpu_torch.eval import ppl as TP
from viscoin_tpu_torch.models.lpips import LPIPS as TLPIPS
from viscoin_tpu_torch.models.stylegan import Generator, generator_config_from_params
from viscoin_tpu_torch.utils.weights import load_jax_tree

B = 4
# Relative to the largest distance of the batch.
ORACLE_TOL = 1e-2  # port fp32 against port float64, epsilon = 1e-4
JAX_TOL = 1e-3     # port against JAX, epsilon = 1e-2 (both fp32)


@pytest.fixture(scope="module")
def nets():
    g, gvars = jax_generator(seed=5)
    x = jnp.zeros((1, 32, 32, 3))
    lp = jax.tree_util.tree_map(np.asarray, perturb(
        run_once(LPIPS().init, jax.random.PRNGKey(7), x, x)["params"], 8))
    tg = load_jax_tree(Generator(**generator_config_from_params(gvars["params"]), device="cpu"),
                       gvars).eval().requires_grad_(False)
    tl = load_jax_tree(TLPIPS(device="cpu"), {"params": lp}).eval().requires_grad_(False)
    return g, gvars, lp, tg, tl


def jax_draws(key, sampling: str, dtype=torch.float32) -> TP.PPLDraws:
    """The z0, z1 and t JAX's ``_path_pair_images`` draws from ``key``."""
    kz0, kz1, kt = jax.random.split(key, 3)
    z0, z1 = jax.random.normal(kz0, (B, 8)), jax.random.normal(kz1, (B, 8))
    t = jax.random.uniform(kt, (B, 1, 1))[:, 0, 0] if sampling == "full" else jnp.zeros(B)
    return TP.PPLDraws(*(torch.tensor(np.asarray(a)).to(dtype) for a in (z0, z1, t)))


def rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def test_ppl_from_distances_matches_jax():
    rng = np.random.default_rng(0)
    d = np.concatenate([rng.lognormal(3.0, 1.0, 297), [1e6, -5.0, 0.0]])
    assert TP.ppl_from_distances(d) == JP.ppl_from_distances(d)
    assert TP.ppl_from_distances(d[:7]) == JP.ppl_from_distances(d[:7])


@pytest.mark.parametrize("sampling", ["end", "full"])
def test_segment_distances(nets, sampling):
    """epsilon = 1e-4: the port within ORACLE_TOL of its float64 run, and
    JAX's one-pass fp32 distances at least 10x further from it (the fault
    of ROADMAP.md §3); epsilon = 1e-2: the port within JAX_TOL of JAX."""
    g, gvars, lp, tg, tl = nets
    key = jax.random.PRNGKey(11)
    got = TP.make_ppl_sampler(tg, tl, 1e-4)(jax_draws(key, sampling)).numpy()
    oracle = TP.make_ppl_sampler(tg.double(), tl.double(), 1e-4)(
        jax_draws(key, sampling, torch.float64)).numpy()
    tg.float(), tl.float()
    jax_1e4 = np.asarray(JP.make_ppl_sampler(g, LPIPS(), B, 1e-4, sampling)(gvars, lp, key))
    assert np.isfinite(got).all() and (oracle > 0).all()
    assert rel(got, oracle) <= ORACLE_TOL, (got, oracle)
    assert rel(jax_1e4, oracle) >= 10 * rel(got, oracle), (jax_1e4, got, oracle)

    got = TP.make_ppl_sampler(tg, tl, 1e-2)(jax_draws(key, sampling)).numpy()
    want = np.asarray(JP.make_ppl_sampler(g, LPIPS(), B, 1e-2, sampling)(gvars, lp, key))
    assert rel(got, want) <= JAX_TOL, (got, want)


def test_compute_ppl_matches_jax(nets, monkeypatch):
    """The whole estimate (2 batches, the [p1, p99] filter) at epsilon = 1e-2
    with JAX's per-batch keys fold_in(PRNGKey(seed), j)."""
    g, gvars, lp, tg, tl = nets
    monkeypatch.setattr(TP, "ppl_draws", lambda seed, j, bs, z_dim, sampling="end": jax_draws(
        jax.random.fold_in(jax.random.PRNGKey(seed), j), sampling))
    got = TP.compute_ppl(tg, tl, 8, B, seed=3, epsilon=1e-2)
    want = JP.compute_ppl(g, gvars, LPIPS(), lp, 8, B, seed=3, epsilon=1e-2)
    assert abs(got - want) <= JAX_TOL * abs(want), (got, want)


def test_torchscript_route(nets, tmp_path, monkeypatch):
    """The distances of JAX's pair images through a TorchScript module
    (tests/test_cli_fid.py's stand-in for the NVlabs vgg16.pt): the port's
    torchscript_pair_distances equal to JAX's (the same module on the same
    fp32 input), and within 2e-3 of tests/test_cli_fid.py's numpy
    oracle taken in float64 (the module's fp32 means of 32² values are
    rounded to ~1e-7 of 127, the pair's difference is ~1e-4 of it, and
    d / eps² squares that difference: ~1e-3); then compute_ppl_torchscript
    with JAX's draws against JAX's, within 1e-2 (each side synthesises its
    own pair: the frameworks' rounding adds the same order again)."""
    g, gvars, _, tg, _ = nets
    ts = str(tmp_path / "vgg16.pt")
    _save_fake_vgg16_pt(ts)
    module = torch.jit.load(ts)
    eps = 1e-4
    img = np.asarray(JP.make_ppl_pair_fn(g, B, eps)(gvars, jax.random.PRNGKey(9)), np.float32)
    x = (np.transpose(img, (0, 3, 1, 2)).astype(np.float64) + 1.0) * (255.0 / 2.0)
    feats = np.concatenate([x.mean(axis=(2, 3)), x.max(axis=(2, 3))], axis=1)
    oracle = ((feats[:B] - feats[B:]) ** 2).sum(axis=1) / (eps * eps)
    got = TP.torchscript_pair_distances(module, torch.from_numpy(
        np.ascontiguousarray(np.transpose(img, (0, 3, 1, 2)))), eps)
    np.testing.assert_array_equal(got, JP.torchscript_pair_distances(module, img, eps))
    np.testing.assert_allclose(got, oracle, rtol=2e-3)

    monkeypatch.setattr(TP, "ppl_draws", lambda seed, j, bs, z_dim, sampling="end": jax_draws(
        jax.random.fold_in(jax.random.PRNGKey(seed), j), sampling))
    got = TP.compute_ppl_torchscript(tg, ts, 8, B, seed=3)
    want = JP.compute_ppl_torchscript(g, gvars, ts, 8, B, seed=3)
    assert abs(got - want) <= 1e-2 * abs(want), (got, want)


def test_tf32_is_off_inside_and_restored():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with TP.no_tf32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_draws_are_seeded_and_shared_by_both_samplings():
    end, full = TP.ppl_draws(3, 1, B, 8, "end"), TP.ppl_draws(3, 1, B, 8, "full")
    assert torch.equal(end.z0, full.z0) and torch.equal(end.z1, full.z1)
    assert not end.t.any() and ((full.t > 0) & (full.t < 1)).all()
    assert not torch.equal(TP.ppl_draws(3, 2, B, 8).z0, end.z0)
    with pytest.raises(ValueError, match="sampling"):
        TP.ppl_draws(3, 1, B, 8, "middle")
