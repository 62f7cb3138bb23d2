"""One whole GAN training step of the port against the JAX package's, on the
CPU at toy widths (16², batch 4, fp32): step 0 (R1 and path-length
regularisation on) and step 1 (both off, an ADA adjustment), from the same
state and the same random numbers (the port's draws rebuilt from the keys
the JAX step splits), every leaf of the new state compared: G and D
parameters, both Adam states, the EMA, w_avg, pl_mean, ada_p and the r_t
accumulator. Then the port alone: bf16, and the draws' determinism."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_gan import B, CFG, IMG, NUM_WS, Z, install_same_noise, jax_nets, torch_nets
from torch_port_helpers import jax_augment_draws, nchw, one_torch_thread  # noqa: F401
from viscoin_tpu.train import gan as jgan
from viscoin_tpu_torch.train import gan as tgan
from viscoin_tpu_torch.utils.weights import tree_to_state_dict

# ADA adjusts after step 1; a short EMA half-life so that the EMA moves.
STEP_CFG = dict(CFG, ada_interval=2, ema_kimg=0.01, style_mixing_prob=0.5)


def port_draws(rng, images_shape, mixing_prob: float | None = None) -> tgan.GANStepDraws:
    """The port's draws from the 17 keys JAX's step splits ``rng`` into
    (style mixing at STEP_CFG's probability unless ``mixing_prob``)."""
    (k_flip, kz1, kz1m, kz2, kz2m, kzp, _kn1, _kn2, _knp, kmix, kcut, kmix2, kcut2, kpl, ka_g,
     ka_df, ka_dr) = jax.random.split(rng, 17)
    prob = STEP_CFG["style_mixing_prob"] if mixing_prob is None else mixing_prob

    def cutoff(km, kc):
        mix = bool(jax.random.bernoulli(km, prob))
        return int(jax.random.randint(kc, (), 1, NUM_WS)) if mix else NUM_WS

    def z(k):
        return torch.tensor(np.asarray(jax.random.normal(k, (B, Z), jnp.float32)))

    return tgan.GANStepDraws(
        flips=torch.tensor(np.asarray(jax.random.bernoulli(k_flip, 0.5, (B,)))),
        z=z(kz1), z_mix=z(kz1m), z2=z(kz2), z2_mix=z(kz2m), cutoff=cutoff(kmix, kcut),
        cutoff2=cutoff(kmix2, kcut2), aug_g=jax_augment_draws(ka_g, B),
        aug_df=jax_augment_draws(ka_df, B), aug_dr=jax_augment_draws(ka_dr, B),
        noise_seeds={"g": 0, "d": 0, "ppl": 0}, zp=z(kzp),
        pl_y=nchw(np.asarray(jax.random.normal(kpl, images_shape, jnp.float32))))


def _adam(opt, module) -> tuple[dict, dict]:
    st = {n: opt.state[p] for n, p in module.named_parameters()}
    return ({n: s["exp_avg"].clone() for n, s in st.items()},
            {n: s["exp_avg_sq"].clone() for n, s in st.items()})


def _close(got: dict, want_tree: dict, rtol: float, label: str):
    want = tree_to_state_dict({"params": want_tree})
    assert set(got) == set(want), label
    worst = 0.0
    for name, w in want.items():
        g = got[name].detach().numpy()
        scale = np.abs(w).max() + 1e-12
        worst = max(worst, float(np.abs(g - w).max() / scale))
        np.testing.assert_allclose(g, w, atol=rtol * scale + 1e-9, err_msg=f"{label}: {name}")
    return worst


def _close_params(got: dict, want_tree: dict, grad_trees: list, lr: float, label: str):
    """Parameters within 1e-5 of their leaf's scale, except where a step's
    gradient so far (Adam's mu, = g with beta1 = 0) was within the moments'
    own tolerance (1e-3 of its leaf's scale) of zero: there Adam's update
    lr * g / (sqrt(v) + eps) turns the rounding of a gradient next to zero
    into a visible step, so those elements may differ by one update's size,
    lr, per such step."""
    want = tree_to_state_dict({"params": want_tree})
    grads = [tree_to_state_dict({"params": t}) for t in grad_trees]
    for name, w in want.items():
        g = got[name].detach().numpy()
        tiny = sum((np.abs(gr[name]) < 1e-3 * np.abs(gr[name]).max()).astype(np.float32)
                   for gr in grads)
        tol = 1e-5 * np.abs(w).max() + 1e-9 + lr * tiny
        assert (np.abs(g - w) <= tol).all(), (label, name, float(np.abs(g - w).max()))


@pytest.fixture(scope="module")
def runs():
    """Both frameworks' states after step 0 and after step 1 (the JAX step
    compiled once), with the same injected synthesis noise."""
    mp = pytest.MonkeyPatch()
    install_same_noise(mp)
    try:
        return _runs()
    finally:
        mp.undo()


def _runs():
    jg, jd, gv, dv = jax_nets()
    jcfg = jgan.GANTrainingParams(**STEP_CFG)
    g_tx, d_tx = jgan._optimizers(jcfg)
    # create_gan_train_state's fields, around the perturbed variables.
    state = jgan.GANTrainState(
        step=jnp.zeros((), jnp.int32), g_params=gv["params"], d_params=dv["params"],
        g_opt_state=g_tx.init(gv["params"]), d_opt_state=d_tx.init(dv["params"]),
        g_ema_params=jax.tree_util.tree_map(jnp.copy, gv["params"]),
        w_avg=jnp.zeros((jg.w_dim,), jnp.float32), pl_mean=jnp.zeros((), jnp.float32),
        ada_p=jnp.asarray(jcfg.augment_p, jnp.float32), ada_rt=jnp.zeros((), jnp.float32))
    extras = {k: v for k, v in gv.items() if k != "params"}
    images = np.random.default_rng(30).integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)
    rngs = [jax.random.PRNGKey(40 + i) for i in range(2)]
    step_j = jgan.make_gan_train_step(jg, jd, jcfg)
    # Compiled once, without XLA's backend optimisations (a program that runs twice).
    compiled = step_j.lower(state, extras, jnp.asarray(images), rngs[0]).compile(
        {"xla_backend_optimization_level": 0})

    tg, td = torch_nets(gv, dv)
    tcfg = tgan.GANTrainingParams(**STEP_CFG)
    tstate = tgan.create_gan_train_state(tg, td, tcfg)
    step_t = tgan.make_gan_train_step(tg, td, tcfg)
    out = []
    for rng in rngs:
        state, mj = compiled(state, extras, jnp.asarray(images), rng)
        state = jax.tree_util.tree_map(np.asarray, state)
        tstate, mt = step_t(tstate, torch.from_numpy(images),
                            port_draws(rng, (B, IMG, IMG, 3)))
        snap = {k: {n: t.detach().clone() for n, t in getattr(tstate, m).named_parameters()}
                for k, m in (("g", "generator"), ("d", "discriminator"), ("ema", "g_ema"))}
        snap.update(g_adam=_adam(tstate.g_opt, tstate.generator),
                    d_adam=_adam(tstate.d_opt, tstate.discriminator),
                    w_avg=tstate.w_avg.clone(), pl_mean=tstate.pl_mean.clone(),
                    ada_p=tstate.ada_p.clone(), ada_rt=tstate.ada_rt.clone(),
                    metrics={k: float(v) for k, v in mt.items()})
        out.append((state, {k: float(v) for k, v in mj.items()}, snap))
    return out


@pytest.mark.parametrize("i", [0, 1], ids=["step0-r1-ppl", "step1-plain"])
def test_gan_step_matches_jax(runs, i):
    """Every leaf of the state after the step: G, D and EMA parameters within
    1e-5 of their leaf's scale (see _close_params); both Adam states (mu, nu: the gradients)
    within 1e-3 of their leaf's scale (D's step-0 gradient is dominated by
    R1's second-order sums, which round differently: 1.3e-4 measured);
    w_avg, pl_mean, ada_p and ada_rt within 1e-5; the metrics within 1e-4."""
    js, jm, ts = runs[i]
    assert (jm["r1"] > 0 and jm["pl_lengths"] > 0) if i == 0 else \
        (jm["r1"] == 0 and jm["pl_lengths"] == 0)
    lr = STEP_CFG.get("learning_rate", tgan.GANTrainingParams.learning_rate)
    g_mus = [runs[j][0].g_opt_state[0].mu for j in range(i + 1)]
    d_mus = [runs[j][0].d_opt_state[0].mu for j in range(i + 1)]
    _close_params(ts["g"], js.g_params, g_mus, lr, "g_params")
    _close_params(ts["d"], js.d_params, d_mus, lr, "d_params")
    _close_params(ts["ema"], js.g_ema_params, g_mus, lr, "g_ema")
    for label, (mu, nu), jopt in (("g", ts["g_adam"], js.g_opt_state),
                                  ("d", ts["d_adam"], js.d_opt_state)):
        _close(mu, jopt[0].mu, 1e-3, f"{label} adam mu")
        _close(nu, jopt[0].nu, 1e-3, f"{label} adam nu")
    np.testing.assert_allclose(ts["w_avg"].numpy(), js.w_avg, atol=1e-5)
    np.testing.assert_allclose(float(ts["pl_mean"]), float(js.pl_mean), atol=1e-5)
    np.testing.assert_allclose(float(ts["ada_p"]), float(js.ada_p), atol=1e-6)
    np.testing.assert_allclose(float(ts["ada_rt"]), float(js.ada_rt), atol=1e-6)
    assert set(ts["metrics"]) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(ts["metrics"][k], v, rtol=1e-4, atol=1e-6, err_msg=k)


def test_draw_step_is_a_function_of_seed_and_step():
    """The step's random numbers come from (seed, step) alone: equal for
    equal arguments, different for another step; the path-length draws
    only on its cadence."""
    tg, _ = torch_nets(*_toy_vars())
    cfg = tgan.GANTrainingParams(**STEP_CFG)
    a, b, c = (tgan.draw_step(cfg, tg, 7, i, "cpu") for i in (4, 4, 5))
    assert torch.equal(a.z, b.z) and torch.equal(a.pl_y, b.pl_y) and a.cutoff == b.cutoff
    assert torch.equal(a.aug_dr.theta, b.aug_dr.theta)
    assert not torch.equal(a.z, c.z) and c.pl_y is None and c.zp is None
    assert a.pl_y.shape == (B, 3, IMG, IMG) and a.flips.dtype == torch.bool


def _toy_vars():
    return jax_nets()[2:]


def test_gan_step_bf16_runs_with_fp32_masters():
    """bf16 compute: finite losses, R1 and path length live on step 0, the
    fp32 masters move, and the losses near the fp32 step's (within 5e-2
    relative: bf16 rounding)."""
    losses = {}
    for dtype in ("float32", "bfloat16"):
        tg, td = torch_nets(*_toy_vars())
        cfg = tgan.GANTrainingParams(**dict(STEP_CFG, compute_dtype=dtype))
        state = tgan.create_gan_train_state(tg, td, cfg)
        before = tg.mapping.fc0.weight.detach().clone()
        images = torch.from_numpy(
            np.random.default_rng(31).integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8))
        _, m = tgan.make_gan_train_step(tg, td, cfg)(state, images,
                                                    tgan.draw_step(cfg, tg, 0, 0, "cpu"))
        assert all(np.isfinite(float(v)) for v in m.values()), m
        assert float(m["r1"]) > 0 and float(m["pl_lengths"]) > 0
        assert tg.mapping.fc0.weight.dtype == torch.float32
        assert not torch.equal(before, tg.mapping.fc0.weight)
        losses[dtype] = (float(m["g_loss"]), float(m["d_loss"]))
    np.testing.assert_allclose(losses["bfloat16"], losses["float32"], rtol=5e-2)
