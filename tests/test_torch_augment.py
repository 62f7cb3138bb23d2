"""ADA's augmentation pipe and controller in the port
(``viscoin_tpu_torch/train/augment.py``) against the JAX package's
(``viscoin_tpu/train/augment.py``), on the CPU: the two-pass warp for random
affine maps, the whole 'bgc' pipe with the random numbers JAX's keys give,
its identity at p = 0, its gradients (first order, and R1's second order
through the warp) and the adaptive-p controller."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import jax_augment_draws, nchw, nhwc, one_torch_thread  # noqa: F401
from viscoin_tpu.train import augment as jaug
from viscoin_tpu_torch.train import augment as taug

B, S = 4, 16


def _images(seed: int, size: int = S) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (B, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("shear", [False, True], ids=["axis-aligned", "rotation"])
def test_twopass_warp_matches_jax(shear):
    """Random maps (scales, translations; with and without a rotation part,
    a10 != 0): fp32 within 1e-5."""
    rng = np.random.default_rng(1)
    A = np.zeros((B, 2, 2), np.float32)
    A[:, 0, 0] = rng.uniform(0.7, 1.3, B)
    A[:, 1, 1] = rng.uniform(0.7, 1.3, B)
    if shear:
        A[:, 0, 1] = rng.uniform(-0.4, 0.4, B)
        A[:, 1, 0] = rng.uniform(-0.4, 0.4, B)
    v = rng.uniform(-3, 3, (B, 2)).astype(np.float32)
    x = _images(2)
    want = np.asarray(jaug.twopass_warp(jnp.asarray(x), jnp.asarray(A), jnp.asarray(v)))
    got = taug.twopass_warp(nchw(x), torch.from_numpy(A), torch.from_numpy(v))
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5)


@pytest.mark.parametrize("p", [0.3, 1.0])
def test_augment_with_jax_draws_matches_jax(p):
    """The whole pipe with the random numbers JAX's key gives, at a partial
    and a full p (every transform on every image): fp32 within 1e-4 of the
    images' scale (the composed 2x2 inverses and 4x4 products round
    differently)."""
    key = jax.random.PRNGKey(3)
    x = _images(4)
    want = np.asarray(jaug.augment(jnp.asarray(x), jnp.float32(p), key))
    got = taug.augment(nchw(x), p, jax_augment_draws(key, B))
    np.testing.assert_allclose(nhwc(got), want, atol=1e-4)


def test_augment_is_the_identity_at_p_zero():
    """p = 0: no image is touched (the warp and the colour product do not
    run); JAX's output within one rounding of its input."""
    key = jax.random.PRNGKey(5)
    x = _images(6)
    got = taug.augment(nchw(x), 0.0, jax_augment_draws(key, B))
    assert torch.equal(got, nchw(x))
    want = np.asarray(jaug.augment(jnp.asarray(x), jnp.float32(0.0), key))
    np.testing.assert_allclose(want, x, atol=1e-6)


def test_augment_draws_from_a_generator_are_reproducible():
    d1 = taug.draw_augment(B, torch.Generator().manual_seed(7))
    d2 = taug.draw_augment(B, torch.Generator().manual_seed(7))
    assert all(torch.equal(getattr(d1, f), getattr(d2, f)) for f in d1.__dataclass_fields__)
    assert d1.frac.shape == (B, 2) and d1.r90_k.dtype == torch.int64
    assert float(d1.tx.abs().max()) <= 0.125 and float(d1.hue.abs().max()) <= np.pi


def test_augment_rejects_non_square_images():
    with pytest.raises(ValueError, match="square"):
        taug.augment(torch.zeros(1, 3, 8, 6), 0.5,
                     taug.draw_augment(1, torch.Generator().manual_seed(0)))


def test_augment_gradients_match_jax_to_second_order():
    """The pipe's vjp, and R1's second order through it: with
    f(x) = sum(augment(x) * c * x) (a nonlinear function of the images),
    d/dc sum((df/dx)^2) against jax.grad of jax.grad; 1e-4 of the scale."""
    key = jax.random.PRNGKey(8)
    x = _images(9)
    c = np.random.default_rng(10).standard_normal((B, S, S, 3)).astype(np.float32)
    draws = jax_augment_draws(key, B)

    def jax_pen(c):
        def f(x):
            return jnp.sum(jaug.augment(x, jnp.float32(0.7), key) * c * x)
        return jnp.sum(jnp.square(jax.grad(f)(jnp.asarray(x))))

    want = np.asarray(jax.grad(jax_pen)(jnp.asarray(c)))
    xt = nchw(x).requires_grad_()
    ct = nchw(c).requires_grad_()
    (gx,) = torch.autograd.grad((taug.augment(xt, 0.7, draws) * ct * xt).sum(), xt,
                                create_graph=True)
    (got,) = torch.autograd.grad(gx.square().sum(), ct)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("rt", [0.9, 0.1, 0.6])
def test_ada_update_matches_jax(rt):
    """Four steps of the controller (one adjustment at the fourth) from
    p = 0.5, r_t above, below and at the target: p and the accumulator
    within 1e-7."""
    p_j, acc_j = jnp.float32(0.5), jnp.float32(0.0)
    p_t, acc_t = torch.tensor(0.5), torch.tensor(0.0)
    for step in range(4):
        p_j, acc_j = jaug.ada_update(p_j, acc_j, jnp.float32(rt), step, 16)
        p_t, acc_t = taug.ada_update(p_t, acc_t, torch.tensor(rt), step, 16)
        np.testing.assert_allclose(float(p_t), float(p_j), atol=1e-7)
        np.testing.assert_allclose(float(acc_t), float(acc_j), atol=1e-7)
    assert float(p_t) != 0.5 or rt == 0.6
