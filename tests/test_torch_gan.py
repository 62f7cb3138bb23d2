"""The GAN trainer's modules and losses in the port against the JAX package,
on the CPU at toy widths (16², channel_base 256, channel_max 16, batch 4,
fp32): the discriminator, its blocks and minibatch-stddev layer, and the
three loss functions (``g_loss_fn``, ``d_loss_fn`` with R1, ``ppl_penalty``),
value and every gradient against ``jax.value_and_grad``.

The JAX variables are perturbed with seeded numpy values and carried into
the port with ``load_jax_tree``. The synthesis noise, drawn from each
framework's own generator in the trainer, is replaced in both by the same
seeded arrays (``same_noise``), so the noise strengths can stay non-zero and
their gradients compare too.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import (  # noqa: F401 - one_torch_thread is an autouse fixture
    jax_augment_draws,
    nchw,
    nhwc,
    one_torch_thread,
    perturb,
    run_once,
)
from viscoin_tpu.models import stylegan as jsg
from viscoin_tpu.train import gan as jgan
from viscoin_tpu_torch.models import stylegan as tsg
from viscoin_tpu_torch.train import gan as tgan
from viscoin_tpu_torch.utils.weights import load_jax_tree, tree_to_state_dict

IMG, Z, WD, B = 16, 8, 16, 4
G_KW = dict(z_dim=Z, w_dim=WD, img_resolution=IMG, channel_base=256, channel_max=16,
            mapping_layers=1)
D_KW = dict(img_resolution=IMG, channel_base=256, channel_max=16, mbstd_group_size=2)
NUM_WS = jsg.num_ws_for_resolution(IMG)


def _noise(batch: int, res: int) -> np.ndarray:
    return np.random.default_rng(1000 + res).standard_normal((batch, res, res, 1)).astype(
        np.float32)


def install_same_noise(mp: pytest.MonkeyPatch) -> None:
    """Both frameworks' synthesis noise (the only (B, res, res, 1) NHWC /
    (B, 1, res, res) NCHW normal draws) become the same seeded arrays."""
    real_jax, real_torch = jax.random.normal, torch.randn

    def jax_normal(key, shape=(), dtype=jnp.float32):
        if len(shape) == 4 and shape[-1] == 1:
            return jnp.asarray(_noise(shape[0], shape[1]), dtype)
        return real_jax(key, shape, dtype)

    def torch_randn(*size, **kw):
        shape = tuple(size[0]) if len(size) == 1 and not isinstance(size[0], int) else size
        if len(shape) == 4 and shape[1] == 1:
            return nchw(_noise(shape[0], shape[2])).to(kw.get("device", "cpu"))
        return real_torch(*size, **kw)

    mp.setattr(jax.random, "normal", jax_normal)
    mp.setattr(torch, "randn", torch_randn)


@pytest.fixture
def same_noise(monkeypatch):
    install_same_noise(monkeypatch)


@functools.lru_cache(maxsize=1)
def jax_nets():
    """The JAX generator and discriminator with perturbed variables (built
    once per test process)."""
    jg, jd = jsg.Generator(**G_KW), jsg.Discriminator(**D_KW)

    def init(key):
        kg, kd = jax.random.split(key)
        gv = jg.init({"params": kg}, jnp.zeros((1, Z)), noise_mode="const")
        return gv, jd.init(kd, jnp.zeros((1, IMG, IMG, 3)))

    gv, dv = run_once(init, jax.random.PRNGKey(0))
    gv = dict(gv, params=perturb(gv["params"], 1))
    return jg, jd, gv, {"params": perturb(dv["params"], 2)}


def torch_nets(gv, dv):
    tg = load_jax_tree(tsg.Generator(**G_KW, device="cpu"), gv)
    td = load_jax_tree(tsg.Discriminator(**D_KW, device="cpu"), dv)
    return tg, td


@pytest.fixture(scope="module")
def nets():
    jg, jd, gv, dv = jax_nets()
    tg, td = torch_nets(gv, dv)
    return dict(jg=jg, jd=jd, gv=gv, dv=dv, tg=tg, td=td)


def _images(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32)


def assert_grads_close(got: dict, want_tree: dict, rtol: float, label: str) -> int:
    """Every leaf of a JAX gradient tree (its params layout) against the
    port's gradients by name: |got - want| <= rtol * the leaf's max |want|
    (plus 1e-7 absolute for leaves that are almost zero in both)."""
    want = tree_to_state_dict({"params": want_tree})
    assert set(got) == set(want), (label, sorted(set(got) ^ set(want)))
    for name, w in want.items():
        g = got[name].detach().numpy()
        np.testing.assert_allclose(g, w, atol=rtol * np.abs(w).max() + 1e-7,
                                   err_msg=f"{label}: {name}")
    return len(want)


# --------------------------------- modules ---------------------------------- #


def test_discriminator_matches_jax(nets):
    """The whole discriminator on 4 images (mbstd groups of 2): fp32
    logits within 1e-5 of their scale."""
    x = _images(3)
    want = np.asarray(run_once(nets["jd"].apply, nets["dv"], jnp.asarray(x)))
    with torch.no_grad():
        got = nets["td"](nchw(x)).numpy()
    assert got.shape == (B, 1)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_epilogue_flattens_in_jax_order(nets):
    """The fc layer reads the 4x4 features in (h, w, c) order, JAX's NHWC
    flatten: the port's output is that; an NCHW (c, h, w) flatten with the
    same carried-over weight is not."""
    td = nets["td"]
    with torch.no_grad():
        x = None
        img = nchw(_images(4))
        for i, res in enumerate(td.resolutions):
            x = getattr(td, f"b{res}")(x, img if i == 0 else None)
        feat = td.conv(td.mbstd(x))
        hwc = td.out(td.fc(feat.permute(0, 2, 3, 1).reshape(B, -1)))
        chw = td.out(td.fc(feat.reshape(B, -1)))
        assert torch.equal(td(img), hwc)
        assert not torch.allclose(hwc, chw, atol=1e-3)


@pytest.mark.parametrize("conv_clamp", [None, 0.25])
def test_discriminator_block_matches_jax(conv_clamp):
    """The first block (fromrgb, the resnet skip, conv0, conv1 down 2) with
    and without a clamp (scaled by the sqrt(0.5) gains of skip and conv1),
    fp32 within 1e-5 of the output's scale."""
    kw = dict(in_channels=0, tmp_channels=8, out_channels=16, conv_clamp=conv_clamp)
    jb = jsg.DiscriminatorBlock(**kw)
    x = _images(5)
    params = perturb(run_once(lambda k, x: jb.init(k, None, x), jax.random.PRNGKey(1),
                              jnp.asarray(x))["params"], 6)
    want, _ = run_once(lambda p, x: jb.apply({"params": p}, None, x), params, jnp.asarray(x))
    tb = load_jax_tree(tsg.DiscriminatorBlock(**kw, device="cpu"), {"params": params})
    with torch.no_grad():
        got = tb(None, nchw(x))
    want = np.asarray(want)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5 * np.abs(want).max())
    if conv_clamp is not None:  # the clamp binds: conv1's output reaches +-0.25 * sqrt(0.5)
        with torch.no_grad():
            y = tb.conv1(tb.conv0(tb.fromrgb(nchw(x))), gain=0.5 ** 0.5)
        assert float(y.abs().max()) == pytest.approx(0.25 * 0.5 ** 0.5, rel=1e-6)


@pytest.mark.parametrize("group", [2, 4])
def test_minibatch_std_matches_jax(group):
    """B = 4 with groups of 2 and 4 (sample s takes the stats of group
    s % (B / G): tiled, not interleaved), 2 stat channels; fp32 within 1e-6."""
    x = np.random.default_rng(7).standard_normal((B, 4, 4, 6)).astype(np.float32)
    x[1] += 3.0  # groups differ
    want = np.asarray(jsg.MinibatchStdLayer(group, 2).apply({}, jnp.asarray(x)))
    got = tsg.MinibatchStdLayer(group, 2)(nchw(x))
    np.testing.assert_allclose(nhwc(got), want, atol=1e-6)
    stats = nhwc(got)[:, 0, 0, 6:]
    if group == 2:  # samples 0 and 2 form a group, as do 1 and 3
        np.testing.assert_array_equal(stats[0], stats[2])
        assert not np.allclose(stats[0], stats[1])


# --------------------------------- losses ----------------------------------- #


CFG = dict(batch_size=B, augment_p=0.5, style_mixing_prob=1.0)
_COMPILED: dict = {}


def jax_value_and_grad(nets, name: str, *args):
    """jax.value_and_grad of the JAX package's loss function ``name`` (all
    arguments traced), compiled once per test process without XLA's backend
    optimisations, called on ``args``."""
    if name not in _COMPILED:
        fns = jgan.make_gan_loss_fns(nets["jg"], nets["jd"], jgan.GANTrainingParams(**CFG))
        _COMPILED[name] = jax.jit(jax.value_and_grad(fns[name], has_aux=True)).lower(
            *args).compile({"xla_backend_optimization_level": 0})
    return _COMPILED[name](*args)


def _jax_extras(gv):
    return {k: v for k, v in gv.items() if k != "params"}


def _latents(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, Z)).astype(np.float32) for _ in range(2)]


def _named(module) -> dict:
    return {n: p.detach().clone().requires_grad_() for n, p in module.named_parameters()}


@pytest.mark.parametrize("cutoff", [3, NUM_WS], ids=["mixed", "unmixed"])
def test_g_loss_fn_matches_jax(nets, same_noise, cutoff):
    """The G loss through style mixing, the synthesis, the ADA pipe (p 0.6,
    JAX's draws) and D: value and batch-mean w within 1e-5, every
    generator gradient within 1e-4 of its leaf's scale."""
    z, z_mix = _latents(8)
    key = jax.random.PRNGKey(9)
    (want, want_ws), want_g = jax_value_and_grad(
        nets, "g_loss_fn", nets["gv"]["params"],
        _jax_extras(nets["gv"]), nets["dv"]["params"], jnp.asarray(z), jnp.asarray(z_mix),
        jnp.int32(cutoff), jax.random.PRNGKey(10), jnp.float32(0.6), key)
    tf = tgan.make_gan_loss_fns(nets["tg"], nets["td"], tgan.GANTrainingParams(**CFG))
    gp = _named(nets["tg"])
    dp = {n: p.detach() for n, p in nets["td"].named_parameters()}
    loss, ws = tf["g_loss_fn"](gp, dp, torch.from_numpy(z), torch.from_numpy(z_mix), cutoff,
                               0, 0.6, jax_augment_draws(key, B))
    grads = dict(zip(gp, torch.autograd.grad(loss, list(gp.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(ws.detach().numpy(), np.asarray(want_ws), atol=1e-5)
    assert assert_grads_close(grads, want_g, 1e-4, "g_loss") == len(gp)


def test_d_loss_fn_with_r1_matches_jax(nets, same_noise):
    """The D loss on fakes and reals through the ADA pipe, plus R1 through
    the pipe and D (second order through both kernels): value, r1 and r_t
    within 1e-5, every discriminator gradient within 1e-4 of its leaf's
    scale."""
    z, z_mix = _latents(11)
    real = _images(12)
    kf, kr = jax.random.PRNGKey(13), jax.random.PRNGKey(14)
    (want, (want_r1, want_rt)), want_g = jax_value_and_grad(
        nets, "d_loss_fn", nets["dv"]["params"],
        nets["gv"]["params"], _jax_extras(nets["gv"]), jnp.asarray(real), jnp.asarray(z),
        jnp.asarray(z_mix), jnp.int32(5), jax.random.PRNGKey(15), jnp.bool_(True),
        jnp.float32(0.6),
        kf, kr)
    tf = tgan.make_gan_loss_fns(nets["tg"], nets["td"], tgan.GANTrainingParams(**CFG))
    dp = _named(nets["td"])
    gp = dict(nets["tg"].named_parameters())
    loss, (r1, rt) = tf["d_loss_fn"](dp, gp, nchw(real), torch.from_numpy(z),
                                     torch.from_numpy(z_mix), 5, 0, True, 0.6,
                                     jax_augment_draws(kf, B), jax_augment_draws(kr, B))
    grads = dict(zip(dp, torch.autograd.grad(loss, list(dp.values()))))
    assert float(r1) > 0
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(r1), float(want_r1), rtol=1e-5)
    np.testing.assert_allclose(float(rt), float(want_rt), atol=1e-6)
    assert assert_grads_close(grads, want_g, 1e-4, "d_loss") == len(dp)


def test_ppl_penalty_matches_jax(nets, same_noise):
    """The path-length penalty (a gradient of the synthesis, differentiated
    again) with NVlabs' non-detached pl_mean: value, mean path length and
    the new pl_mean within 1e-5, every generator gradient within 1e-4 of its
    leaf's scale."""
    z, _ = _latents(16)
    kpl = jax.random.PRNGKey(17)
    (want, (want_len, want_mean)), want_g = jax_value_and_grad(
        nets, "ppl_penalty", nets["gv"]["params"],
        _jax_extras(nets["gv"]), jnp.asarray(z), jax.random.PRNGKey(18), kpl,
        jnp.float32(0.3))
    pl_y = np.asarray(jax.random.normal(kpl, (B, IMG, IMG, 3), jnp.float32))
    tf = tgan.make_gan_loss_fns(nets["tg"], nets["td"], tgan.GANTrainingParams(**CFG))
    gp = _named(nets["tg"])
    loss, (pl_len, new_mean) = tf["ppl_penalty"](gp, torch.from_numpy(z), 0, nchw(pl_y),
                                                 torch.tensor(0.3))
    # Leaves that only shift the image (the torgb biases) have no path-length
    # gradient: zeros, as in JAX.
    grads = dict(zip(gp, torch.autograd.grad(loss, list(gp.values()), materialize_grads=True)))
    assert float(pl_len.detach()) > 0
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(pl_len.detach()), float(want_len), rtol=1e-5)
    np.testing.assert_allclose(float(new_mean), float(want_mean), rtol=1e-5)
    assert assert_grads_close(grads, want_g, 1e-4, "ppl") == len(gp)
