"""The port's training slice against the JAX package, on the CPU, at toy
widths: the original generator and its mapping, LPIPS, the explainer's
dropout, the flip preprocess, all eleven losses, the LR schedule and Adam,
and the whole step's loss and gradients against
``jax.value_and_grad(make_loss_fn)``.

The step runs at 64²: at 32² the tiny ResNet's last stage is 1x1, the
adaptive pool replicates each concept map over 3x3, and the explainer's
max-pool has 9-way ties whose subgradient is an implementation choice. The
synthesis noise strengths are zero (random noise then adds nothing, in
either framework) and the explainer's dropout mask is the one JAX drew
(extracted as ``tests/test_training_dynamics.py`` does). Weights are the
JAX init perturbed with seeded numpy, carried across by
``utils/weights.py``.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import NC, NK, jax_bundle, nchw, nhwc, perturb, torch_bundle
from viscoin_tpu.data.transforms import device_preprocess as jax_device_preprocess
from viscoin_tpu.models.explainer import Explainer
from viscoin_tpu.models.lpips import LPIPS
from viscoin_tpu.models.stylegan import (
    Generator,
    GeneratorAdapted,
    MappingNetwork,
    adapted_params_from_gan,
)
from viscoin_tpu.train import losses as JL
from viscoin_tpu.train.viscoin import VisCoINTrainingParams as JParams
from viscoin_tpu.train.viscoin import make_frozen as jax_make_frozen
from viscoin_tpu.train.viscoin import make_loss_fn as jax_make_loss_fn
from viscoin_tpu.train.viscoin import make_lr_schedule as jax_make_lr_schedule
from viscoin_tpu_torch.data.transforms import device_preprocess
from viscoin_tpu_torch.models.bundle import default_models, init_models
from viscoin_tpu_torch.models.explainer import Explainer as TExplainer
from viscoin_tpu_torch.models.lpips import LPIPS as TLPIPS
from viscoin_tpu_torch.models.stylegan import Generator as TGenerator
from viscoin_tpu_torch.models.stylegan import GeneratorAdapted as TGeneratorAdapted
from viscoin_tpu_torch.models.stylegan import MappingNetwork as TMappingNetwork
from viscoin_tpu_torch.models.stylegan import adapted_state_from_gan
from viscoin_tpu_torch.train import losses as TL
from viscoin_tpu_torch.train import viscoin as T
from viscoin_tpu_torch.utils.weights import load_jax_tree, tree_to_state_dict

IMG, B = 64, 2
TOL = 1e-4


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=tol, atol=tol * scale)


def _zero_noise_strength(tree):
    return jax.tree_util.tree_map_with_path(
        lambda p, x: np.zeros_like(x) if getattr(p[-1], "key", None) == "noise_strength" else x,
        tree)


# ------------------------------- the modules -------------------------------- #

GEN = dict(z_dim=16, w_dim=32, img_resolution=16, channel_base=512, channel_max=32)


@pytest.fixture(scope="module")
def jax_generator(seed: int = 0):
    """The JAX generator, its perturbed variables and a latent batch (JAX
    calls are jitted: one compile is cheaper than op-by-op dispatch)."""
    g = Generator(mapping_layers=2, **GEN)
    z = np.random.default_rng(seed).standard_normal((2, 16)).astype(np.float32)
    v = jax.jit(lambda k, z: g.init({"params": k}, z, noise_mode="const"))(
        jax.random.PRNGKey(seed), jnp.asarray(z))
    return g, perturb(v, seed + 1), z


@pytest.mark.parametrize("truncation", [(1.0, None), (0.7, None), (0.5, 3)], ids=str)
def test_generator_matches_jax(jax_generator, truncation):
    """The original generator (mapping with 2 layers, w_avg truncation,
    synthesis with the noise_const buffers) from its JAX variables."""
    psi, cutoff = truncation
    g, v, z = jax_generator
    want = jax.jit(lambda v, z: g.apply(v, z, truncation_psi=psi, truncation_cutoff=cutoff,
                                        noise_mode="const"))(v, jnp.asarray(z))
    tg = load_jax_tree(TGenerator(mapping_layers=2, **GEN, device="cpu"), v)
    with torch.no_grad():
        got = tg(torch.from_numpy(z), truncation_psi=psi, truncation_cutoff=cutoff,
                 noise_mode="const")
    assert got.shape == (2, 3, 16, 16)
    _close(nhwc(got), want)


def test_mapping_network_matches_jax():
    """MappingNetwork alone: 3 lrelu layers, lr_multiplier 0.01, truncation."""
    m = MappingNetwork(z_dim=12, w_dim=20, num_ws=5, num_layers=3)
    z = np.random.default_rng(3).standard_normal((4, 12)).astype(np.float32)
    v = perturb(m.init(jax.random.PRNGKey(3), jnp.asarray(z)), 4)
    tm = load_jax_tree(TMappingNetwork(z_dim=12, w_dim=20, num_ws=5, num_layers=3,
                                       device="cpu"), v)
    for psi in (1.0, 0.6):
        want = m.apply(v, jnp.asarray(z), truncation_psi=psi)
        with torch.no_grad():
            got = tm(torch.from_numpy(z), truncation_psi=psi)
        assert got.shape == (4, 5, 20)
        _close(got.numpy(), want)


def test_adapted_state_from_gan_matches_jax(jax_generator):
    """The synthesis weights and noise buffers of a Generator transplanted
    into a GeneratorAdapted, as adapted_params_from_gan does."""
    _, v, _ = jax_generator
    ga = GeneratorAdapted(z_dim=4, **{k: GEN[k] for k in ("w_dim", "img_resolution",
                                                            "channel_base", "channel_max")})
    rng = np.random.default_rng(5)
    phi, phi_prime = rng.standard_normal((1, 3, 3, 4)), rng.standard_normal((1, 36))
    va = perturb(jax.jit(lambda k, a, b: ga.init({"params": k}, a, b, noise_mode="const"))(
        jax.random.PRNGKey(5), jnp.asarray(phi, jnp.float32),
        jnp.asarray(phi_prime, jnp.float32)), 6)
    want = tree_to_state_dict(adapted_params_from_gan(va, v))
    got = adapted_state_from_gan(tree_to_state_dict(va), tree_to_state_dict(v))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    tga = TGeneratorAdapted(z_dim=4, device="cpu", **{
        k: GEN[k] for k in ("w_dim", "img_resolution", "channel_base", "channel_max")})
    tga.load_state_dict({k: torch.from_numpy(a) for k, a in got.items()}, strict=True)


@pytest.fixture(scope="module")
def lpips_params():
    """Perturbed JAX LPIPS params (their shapes do not depend on the input size)."""
    x = jnp.zeros((1, 16, 16, 3))
    return perturb(jax.jit(LPIPS().init)(jax.random.PRNGKey(7), x, x)["params"], 8)


def test_lpips_matches_jax(lpips_params):
    """VGG16 slices, shift/scale, the lin heads and the one-pass distance,
    at 16² (five slices down to 1x1)."""
    rng = np.random.default_rng(7)
    x, y = (rng.standard_normal((2, 16, 16, 3)).astype(np.float32) for _ in range(2))
    want = jax.jit(LPIPS().apply)({"params": lpips_params}, jnp.asarray(x), jnp.asarray(y))
    tnet = load_jax_tree(TLPIPS(device="cpu"), {"params": lpips_params})
    with torch.no_grad():
        got = tnet(nchw(x), nchw(y))
    assert got.shape == (2,)
    _close(got.numpy(), want)


def test_lpips_random_init_and_identity():
    """A seeded init gives non-negative heads and a zero distance to itself."""
    net = init_models(TLPIPS(device="cpu"), seed=0)
    assert all((getattr(net, f"lin{i}") >= 0).all() for i in range(5))
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert float(net(x, x).abs().max()) < 1e-5
        assert (net(x, torch.flip(x, [3])) > 0).all()


def test_explainer_dropout_replays_the_jax_mask():
    """Training mode with JAX's dropout mask gives JAX's logits (kept values
    scaled by 1 / 0.99); eval mode has no dropout; a mask drawn from a
    generator changes the logits."""
    phi = np.random.default_rng(9).standard_normal((64, 3, 3, NK)).astype(np.float32)
    theta = Explainer(n_concepts=NK, n_classes=NC)
    params = perturb(theta.init(jax.random.PRNGKey(9), jnp.asarray(phi)), 10)
    key = jax.random.PRNGKey(9)
    want = theta.apply(params, jnp.asarray(phi), train=True, rngs={"dropout": key})
    _, inter = theta.apply(params, jnp.ones(phi.shape), train=True, rngs={"dropout": key},
                           capture_intermediates=True)
    mask = np.asarray(jax.tree_util.tree_leaves(inter["intermediates"]["Dropout_0"])[0]) > 0
    assert 0 < (~mask).sum()
    tm = load_jax_tree(TExplainer(n_concepts=NK, n_classes=NC, device="cpu"), params)
    with torch.no_grad():
        got = tm(nchw(phi), train=True, dropout_mask=nchw(mask))
        drawn = tm(nchw(phi), train=True, generator=torch.Generator().manual_seed(0))
        off = tm(nchw(phi))
    _close(got.numpy(), want)
    _close(off.numpy(), theta.apply(params, jnp.asarray(phi)))
    assert got.shape == drawn.shape == (64, NC) and not torch.equal(drawn, off)


def test_preprocess_flip_matches_jax():
    imgs = np.random.default_rng(10).integers(0, 256, (4, 8, 6, 3), dtype=np.uint8)
    flips = np.array([True, False, True, False])
    want = jax_device_preprocess(jnp.asarray(imgs), jnp.asarray(flips))
    got = device_preprocess(torch.from_numpy(imgs), torch.from_numpy(flips))
    _close(nhwc(got), want, tol=1e-6)
    _close(nhwc(device_preprocess(torch.from_numpy(imgs))),
           jax_device_preprocess(jnp.asarray(imgs)), tol=1e-6)


# --------------------------------- the losses -------------------------------- #


def _loss_inputs():
    rng = np.random.default_rng(11)
    f32 = np.float32
    return dict(
        logits=(rng.standard_normal((4, 6)) * 3).astype(f32),
        logits2=(rng.standard_normal((4, 6)) * 3).astype(f32),
        phi=np.abs(rng.standard_normal((4, 3, 3, 5))).astype(f32),  # NHWC
        conv5=rng.standard_normal((1, 1, 12, 5)).astype(f32),  # HWIO
        img=rng.standard_normal((2, 8, 8, 3)).astype(f32),
        img2=rng.standard_normal((2, 8, 8, 3)).astype(f32),
        ws=rng.standard_normal((2, 4, 7)).astype(f32),
        w_avg=rng.standard_normal(7).astype(f32),
        labels=rng.integers(0, 6, 4).astype(np.int32),
        q=rng.standard_normal((4, 9)).astype(f32),
        k=rng.standard_normal((4, 9)).astype(f32),
        neg=rng.standard_normal((5, 9)).astype(f32),
        negp=rng.standard_normal((4, 3, 9)).astype(f32),
    )


def _lpips_stub(module):
    """A smooth stand-in for LPIPS: mean squared difference per sample."""
    return lambda a, b: module.mean(module.square(a - b), axis=(1, 2, 3)) \
        if module is jnp else (a - b).square().mean(dim=(1, 2, 3))


LOSS_CASES = {
    "entropy_loss": (lambda L, a, m: L.entropy_loss(a(m["logits"]))),
    "cross_cross_entropy_loss": (lambda L, a, m: L.cross_cross_entropy_loss(
        a(m["logits"]), a(m["logits2"]))),
    "l1_loss": (lambda L, a, m: L.l1_loss(a(m["logits"]))),
    "conciseness_diversity_loss": (lambda L, a, m: L.conciseness_diversity_loss(
        a(m["phi"], img=True), eta=0.5)),
    "concept_regularization_loss": (lambda L, a, m: L.concept_regularization_loss(
        a(m["phi"], img=True))),
    "concept_orthogonality_loss": (lambda L, a, m: L.concept_orthogonality_loss(
        a(m["conv5"], hwio=True))),
    "reconstruction_loss": (lambda L, a, m: L.reconstruction_loss(
        a(m["img"], img=True), a(m["img2"], img=True), a(m["logits"]), a(m["logits2"]),
        _lpips_stub(jnp if L is JL else torch), lambda_classes=0.3, lambda_lpips=2.0)),
    "output_fidelity_loss": (lambda L, a, m: L.output_fidelity_loss(
        a(m["logits"]), a(m["logits2"]))),
    "gan_regularization_loss": (lambda L, a, m: L.gan_regularization_loss(
        a(m["ws"]), a(m["w_avg"]))),
    "info_nce": (lambda L, a, m: L.info_nce(a(m["q"]), a(m["k"])) + L.info_nce(
        a(m["q"]), a(m["k"]), a(m["neg"])) + L.info_nce(a(m["q"]), a(m["k"]), a(m["negp"]),
                                                      negative_mode="paired")),
    "softmax_cross_entropy": (lambda L, a, m: L.softmax_cross_entropy(
        a(m["logits"]), a(m["labels"]))),
}


# The input whose gradient each case compares (the logits where not named).
LEAF = {"output_fidelity_loss": "logits2", "conciseness_diversity_loss": "phi",
        "concept_regularization_loss": "phi",
        "concept_orthogonality_loss": "conv5", "reconstruction_loss": "img",
        "gan_regularization_loss": "ws", "info_nce": "q"}


def _as_jax(x, img=False, hwio=False):
    return jnp.asarray(x)


def _as_torch(x, img=False, hwio=False):
    if hwio:  # HWIO -> OIHW
        return torch.from_numpy(np.ascontiguousarray(x.transpose(3, 2, 0, 1)))
    return nchw(x) if img else torch.from_numpy(x)


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_matches_jax(name):
    """Each of the eleven losses, its value and the gradient of one input,
    in fp32; 1e-5 (the same formulas)."""
    assert len(LOSS_CASES) == 11 and all(hasattr(TL, n) for n in LOSS_CASES)
    fn, m = LOSS_CASES[name], _loss_inputs()
    leaf = LEAF.get(name, "logits")
    layout = dict(img=leaf in ("phi", "img"), hwio=leaf == "conv5")
    tv = _as_torch(m[leaf], **layout).requires_grad_()
    got = fn(TL, lambda x, **kw: tv if x is m[leaf] else _as_torch(x, **kw), m)
    want, gw = jax.value_and_grad(
        lambda v: fn(JL, lambda x, **kw: v if x is m[leaf] else _as_jax(x, **kw), m))(
        jnp.asarray(m[leaf]))
    _close(got.detach().numpy(), want, tol=1e-5)
    got.backward()
    gw = np.asarray(gw)
    if layout["img"]:
        gw = gw.transpose(0, 3, 1, 2)
    elif layout["hwio"]:
        gw = gw.transpose(3, 2, 0, 1)
    _close(tv.grad.numpy(), gw, tol=1e-5)


# ---------------------------- schedule and Adam ------------------------------ #


def test_lr_schedule_matches_jax_across_decays():
    """x0.8 per 1000 iterations after the first half: steps around each
    boundary of a 5000-iteration run."""
    ours, ref = T.make_lr_schedule(3e-4, 5000), jax_make_lr_schedule(3e-4, 5000)
    for step in (0, 1, 2499, 2500, 2501, 3499, 3500, 3501, 4499, 4500, 4999, 5000, 7000):
        np.testing.assert_allclose(ours(step), float(ref(jnp.int32(step))), rtol=1e-6)
    assert ours(3500) == pytest.approx(3e-4 * 0.8) and ours(4500) == pytest.approx(3e-4 * 0.64)


def test_adam_matches_optax_over_three_steps():
    """The two port Adams against optax.adam(schedule) fed the same
    gradients for 3 steps, with the schedule decaying at every step."""
    rng = np.random.default_rng(12)
    cfg = T.VisCoINTrainingParams(learning_rate=1e-2, iterations=0)
    shapes = {"concept_extractor": {"w": (3, 4)}, "explainer": {"b": (5,)},
              "mapping": {"m": (2, 2)}}
    init = {g: {n: rng.standard_normal(s).astype(np.float32) for n, s in grp.items()}
            for g, grp in shapes.items()}
    params = {g: {n: torch.nn.Parameter(torch.from_numpy(a.copy())) for n, a in grp.items()}
              for g, grp in init.items()}
    opt, gan_opt = T.make_optimizers(cfg, params)
    # decays every step: lr * 0.8 ** (step // 1000) would not move, so scale the clock
    sched = lambda step: 1e-2 * 0.5 ** step  # noqa: E731
    tx = optax.adam(lambda count: 1e-2 * 0.5 ** count)
    jparams = jax.tree_util.tree_map(jnp.asarray, init)
    state = tx.init(jparams)
    for step in range(3):
        grads = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                                       init)
        for g, grp in params.items():
            for n, p in grp.items():
                p.grad = torch.from_numpy(grads[g][n])
        for o in (opt, gan_opt):
            for group in o.param_groups:
                group["lr"] = sched(step)
            o.step()
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    for g, grp in params.items():
        for n, p in grp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[g][n]),
                                       rtol=1e-6, atol=1e-7)
    with pytest.raises(NotImplementedError, match="gradient_accumulation"):
        T.make_optimizers(T.VisCoINTrainingParams(gradient_accumulation=2), params)


# ---------------------------------- the step --------------------------------- #


@pytest.fixture(scope="module")
def step_ref(lpips_params):
    """The JAX side, built once: the 64² bundle with zero noise strengths,
    LPIPS params, inputs, jax.value_and_grad(make_loss_fn) and the dropout
    mask it drew."""
    jm = jax_bundle(img=IMG)
    jm.gan_vars = _zero_noise_strength(jm.gan_vars)
    rng = np.random.default_rng(13)
    real = rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32)
    fake = rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32)
    labels = rng.integers(0, NC, B).astype(np.int32)
    lpips = LPIPS()
    cfg = JParams(batch_size=B, cd_fid_iteration=-1)
    step_rng = jax.random.PRNGKey(5)
    params = {"concept_extractor": jm.concept_params, "explainer": jm.explainer_params,
              "mapping": jm.gan_vars["params"]["mapping"]}
    frozen = jax_make_frozen(jm, {"params": {}}, lpips_params)
    (total, metrics), grads = jax.jit(jax.value_and_grad(
        jax_make_loss_fn(jm, None, lpips, cfg), has_aux=True))(
        params, frozen, jnp.asarray(real), jnp.asarray(labels), jnp.int32(0), step_rng,
        jnp.asarray(fake))
    _, _, _, k_drop = jax.random.split(step_rng, 4)
    _, inter = jm.explainer.apply({"params": jm.explainer_params}, jnp.ones((2 * B, 3, 3, NK)),
                                  train=True, rngs={"dropout": k_drop}, capture_intermediates=True)
    mask = np.asarray(jax.tree_util.tree_leaves(inter["intermediates"]["Dropout_0"])[0]) > 0
    want = {g: tree_to_state_dict({"params": grads[g]}) for g in grads}
    return dict(jm=jm, real=real, fake=fake, labels=labels, lpips_params=lpips_params,
                total=float(total), metrics={k: float(v) for k, v in metrics.items()},
                grads=want, mask=mask)


def _port(step_ref, **cfg_kw):
    tm = torch_bundle(step_ref["jm"], img=IMG)
    lp = load_jax_tree(TLPIPS(device="cpu"), {"params": step_ref["lpips_params"]})
    cfg = T.VisCoINTrainingParams(batch_size=B, cd_fid_iteration=-1, **cfg_kw)
    frozen = T.make_frozen(tm, None, lp, cfg.compute_dtype)
    return tm, lp, cfg, frozen, T.create_train_state(tm, cfg)


@pytest.mark.parametrize("remat", ["", "lpips+classifier+gan"], ids=["plain", "remat"])
def test_step_loss_and_gradients_match_jax(step_ref, remat):
    """make_loss_fn's total and metrics (rtol 1e-4) and the gradient of every
    trainable leaf of Psi, Theta and the adapted mapping (rtol 5e-3, atol
    5e-4 of the leaf's max |grad|) against jax.value_and_grad of the JAX
    make_loss_fn; with remat the same gradients."""
    tm, lp, cfg, frozen, state = _port(step_ref, remat=remat)
    loss_fn = T.make_loss_fn(tm, None, lp, cfg)
    total, metrics = loss_fn(state.params, frozen, nchw(step_ref["real"]),
                             torch.from_numpy(step_ref["labels"]), 0,
                             torch.Generator().manual_seed(0), nchw(step_ref["fake"]),
                             dropout_mask=nchw(step_ref["mask"]))
    np.testing.assert_allclose(float(total.detach()), step_ref["total"], rtol=1e-4)
    for k, v in step_ref["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-4, atol=1e-6, err_msg=k)
    leaves = [(g, n, p) for g, grp in state.params.items() for n, p in grp.items()]
    grads = torch.autograd.grad(total, [p for _, _, p in leaves])
    assert sorted((g, n) for g, n, _ in leaves) == sorted(
        (g, n) for g, grp in step_ref["grads"].items() for n in grp)
    for (g, n, _), got in zip(leaves, grads):
        want = step_ref["grads"][g][n]
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-3, atol=5e-4 * scale,
                                   err_msg=f"{g}.{n}")
        assert float(got.abs().max()) > 0, f"{g}.{n}"


def test_train_step_updates_in_place_in_both_dtypes(step_ref):
    """make_train_step with external fakes and the flip preprocess: one step
    updates every trainable leaf, keeps the fp32 masters fp32 and advances
    the count; bf16 runs the frozen modules on bf16 copies, and its total is
    within 5 % of fp32's at this toy size."""
    totals = {}
    for dtype in ("float32", "bfloat16"):
        tm, lp, cfg, frozen, state = _port(step_ref, compute_dtype=dtype)
        before = {(g, n): p.detach().clone() for g, grp in state.params.items()
                  for n, p in grp.items()}
        step = T.make_train_step(tm, None, lp, cfg, external_fakes=True)
        imgs = torch.from_numpy(np.random.default_rng(15).integers(0, 256, (B, IMG, IMG, 3),
                                                                   dtype=np.uint8))
        state, metrics = step(state, frozen, imgs, torch.from_numpy(step_ref["labels"]),
                              T.step_generator(0, 0, "cpu"), nchw(step_ref["fake"]))
        assert state.step == 1 and np.isfinite(float(metrics["total_loss"]))
        for (g, n), old in before.items():
            p = state.params[g][n]
            assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
            assert not torch.equal(p.detach(), old), f"{dtype}: {g}.{n} did not move"
        assert frozen["classifier"].linear.weight.dtype == getattr(torch, dtype)
        assert not frozen["classifier"].linear.weight.requires_grad
        totals[dtype] = float(metrics["total_loss"])
        with pytest.raises(ValueError, match="external_fakes"):
            step(state, frozen, imgs, torch.from_numpy(step_ref["labels"]),
                 T.step_generator(0, 1, "cpu"))
    np.testing.assert_allclose(totals["bfloat16"], totals["float32"], rtol=5e-2)


def test_sample_fakes_and_seeds():
    """Fakes come out (K, B, 3, H, W) in the compute dtype; a row's latents
    depend on its step's seed alone (noise strengths are zero at init, so
    the image does too); seeds are pure functions of (seed, step)."""
    tg = init_models(TGenerator(mapping_layers=2, **GEN, device="cpu"), seed=0)
    cfg = T.VisCoINTrainingParams(batch_size=3)
    models = default_models(n_classes=2, n_concepts=2, img_resolution=8, channel_base=64,
                            channel_max=8, device="cpu")
    frozen = T.make_frozen(models, tg, None)
    sample = T.make_sample_fakes(tg, cfg)
    a = sample(frozen, T.fake_sample_keys(7, 0, 2))
    b = sample(frozen, T.fake_sample_keys(7, 1, 2))
    assert a.shape == (2, 3, 3, 16, 16) and a.dtype == torch.float32
    torch.testing.assert_close(a[1], b[0])
    assert not torch.allclose(a[0], a[1])
    assert T.fake_sample_keys(7, 1, 1) == T.fake_sample_keys(7, 0, 2)[1:]
    assert T.fold_seed(7, 3) == T.fold_seed(7, 3) != T.fold_seed(7, 4)
    assert T.fake_sample_keys(7, 3, 1)[0] != T.fold_seed(7, 3)
    r1 = torch.rand(4, generator=T.step_generator(7, 3, "cpu"))
    assert torch.equal(r1, torch.rand(4, generator=T.step_generator(7, 3, "cpu")))
    with pytest.raises(ValueError, match="remat"):
        T.make_loss_fn(models, None, None, T.VisCoINTrainingParams(remat="vgg"))
    with pytest.raises(NotImplementedError, match="mesh"):
        T.make_train_step(None, None, None, cfg, mesh=object())
