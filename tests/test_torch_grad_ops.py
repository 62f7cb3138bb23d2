"""Gradients of the port's ops against ``jax.grad`` / ``jax.vjp`` of the JAX
package's ops, on the CPU.

``bias_act`` and ``upfirdn2d`` are ``torch.autograd.Function``s: on a CPU
tensor their backward is the plain version of the backward kernel
(``bias_act_grad_plain``) or the adjoint upfirdn2d (``adjoint_padding``),
held here against the JAX XLA path, ties included. The CUDA backward kernels
are held against these plain versions on the card (``tests/test_torch_gpu.py``
and ``chip_smoke.py``). The convolutions are torch's, checked at the
generator's up-conv and plain-conv geometries.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_ops import F1D, UPFIRDN_CASES
from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from viscoin_tpu.ops import conv2d_resample as jax_conv2d_resample
from viscoin_tpu.ops import modulated_conv2d as jax_modulated_conv2d
from viscoin_tpu.ops import setup_filter as jax_setup_filter
from viscoin_tpu.ops import upfirdn2d as jax_upfirdn2d
from viscoin_tpu.ops.bias_act import bias_act as jax_bias_act
from viscoin_tpu_torch.ops import (
    bias_act,
    conv2d_resample,
    modulated_conv2d,
    setup_filter,
    upfirdn2d,
)
from viscoin_tpu_torch.ops.bias_act import bias_act_grad_plain
from viscoin_tpu_torch.ops.upfirdn2d import adjoint_padding

# ---------------------------------- bias_act -------------------------------- #

# (act, kwargs). Gain 1 with clamp 0.5 puts ties on the 1/8 grid of the
# inputs below: t = 0 (relu, lrelu) and y0 = -0.5 or +0.5 (the clamp).
GRAD_CASES = [
    ("linear", dict()),
    ("relu", dict()),
    ("lrelu", dict()),
    ("lrelu", dict(alpha=0.05)),
    ("linear", dict(gain=1.0, clamp=0.5)),
    ("relu", dict(gain=1.0, clamp=0.5)),
    ("lrelu", dict(gain=1.0, clamp=0.5)),
    ("lrelu", dict(clamp=1.0)),
    ("lrelu", dict(gain=1.0, clamp=0.0)),  # a zero clamp: both ties at once
]
SHAPES = [(2, 5, 4, 3), (3, 7)]  # an (n, c) plane per row; (B, F) features


def _grid_inputs(shape, seed):
    """x, b and dy on dyadic grids, so that t = x + b is exact and hits 0
    and +-0.5 (at least at the first three elements); dy random."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-24, 25, shape) / 8).astype(np.float32)
    b = (rng.integers(-8, 9, shape[1]) / 8).astype(np.float32)
    for i, t in enumerate((0.0, 0.5, -0.5)):
        idx = np.unravel_index(i, shape)
        x[idx] = t - b[idx[1]]
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, b, dy


def _jax_grads(x, b, dy, act, kw, dtype=jnp.float32):
    def f(x, b):
        return jnp.sum(jax_bias_act(x, b, axis=1, act=act, **kw).astype(jnp.float32) * dy)
    gx, gb = jax.grad(f, argnums=(0, 1))(jnp.asarray(x, dtype), jnp.asarray(b, dtype))
    return np.asarray(gx.astype(jnp.float32)), np.asarray(gb.astype(jnp.float32))


def _torch_grads(x, b, dy, act, kw, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    bt = torch.from_numpy(b).to(dtype).requires_grad_()
    bias_act(xt, bt, act=act, **kw).backward(torch.from_numpy(dy).to(dtype))
    return xt.grad, bt.grad


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("act,kw", GRAD_CASES, ids=[f"{a}-{k}" for a, k in GRAD_CASES])
def test_bias_act_grad_matches_jax_grad(act, kw, shape):
    """dx and db against jax.grad of the XLA path, ties included (inputs on a
    grid where t = 0 and y0 = +-clamp occur); fp32 within 1e-6."""
    x, b, dy = _grid_inputs(shape, 11)
    gx, gb = _torch_grads(x, b, dy, act, kw)
    wx, wb = _jax_grads(x, b, dy, act, kw)
    np.testing.assert_allclose(gx.numpy(), wx, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gb.numpy(), wb, rtol=1e-5, atol=1e-5)
    if kw.get("clamp") == 0.5:  # the grid does reach the ties
        t = x + b.reshape([1, -1] + [1] * (x.ndim - 2))
        assert (t == 0).any() and (t == 0.5).any() and (t == -0.5).any()


@pytest.mark.parametrize("act,kw", [("lrelu", dict()), ("relu", dict(gain=1.0, clamp=0.5)),
                                    ("linear", dict(gain=1.0, clamp=0.5))], ids=str)
def test_bias_act_grad_bf16_matches_jax_grad(act, kw):
    """bf16 in both frameworks (JAX computes in bf16, the port in fp32 and
    rounds dx once): within 1e-2 of the gradient's scale; the ties agree."""
    x, b, dy = _grid_inputs((2, 6, 4, 4), 12)
    dy = dy.astype(jnp.bfloat16).astype(np.float32)
    gx, gb = _torch_grads(x, b, dy, act, kw, torch.bfloat16)
    wx, wb = _jax_grads(x, b, dy, act, kw, jnp.bfloat16)
    assert gx.dtype == torch.bfloat16 and gb.dtype == torch.bfloat16
    np.testing.assert_allclose(gx.float().numpy(), wx, atol=1e-2 * np.abs(wx).max())
    np.testing.assert_allclose(gb.float().numpy(), wb, atol=1e-2 * np.abs(wb).max())


def test_bias_act_grad_of_expanded_dy_and_partial_needs():
    """dy from a mean is an expanded, stride-0 tensor; db only when the bias
    needs it (and then in the bias's own dtype); a bias-free call."""
    x, b, _ = _grid_inputs((2, 5, 4, 3), 13)
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    bt = torch.from_numpy(b)  # fp32 bias on a bf16 input, no gradient
    bias_act(xt, bt, act="lrelu").mean().backward()
    dy = np.full(x.shape, 1.0 / x.size, np.float32)
    wx, _ = _jax_grads(x, b, dy, "lrelu", {})
    np.testing.assert_allclose(xt.grad.float().numpy(), wx, rtol=1e-2, atol=1e-6)
    assert bt.grad is None

    xt = torch.from_numpy(x)
    bt = torch.from_numpy(b).requires_grad_()
    bias_act(xt, bt, act="relu").sum().backward()
    _, wb = _jax_grads(x, b, np.ones_like(x), "relu", {})
    assert bt.grad.dtype == torch.float32
    np.testing.assert_allclose(bt.grad.numpy(), wb, rtol=1e-6)

    x3 = np.random.default_rng(14).standard_normal((2, 4, 6)).astype(np.float32)
    xt = torch.from_numpy(x3).requires_grad_()
    bias_act(xt, None, act="lrelu").sum().backward()
    gx = jax.grad(lambda v: jnp.sum(jax_bias_act(v, None, act="lrelu")))(jnp.asarray(x3))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-6)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bias_act_gradcheck_float64(shape):
    """torch.autograd.gradcheck of the Function in float64, away from kinks."""
    gen = torch.Generator().manual_seed(15)
    x = torch.randn(shape, dtype=torch.float64, generator=gen).requires_grad_()
    b = torch.randn(shape[1], dtype=torch.float64, generator=gen).requires_grad_()
    for act, kw in (("lrelu", dict()), ("relu", dict(clamp=1.0)), ("linear", dict(gain=3.0))):
        assert torch.autograd.gradcheck(lambda x, b: bias_act(x, b, act=act, **kw), (x, b))


def test_bias_act_double_backward_raises():
    """Two orders, not three: the second backward runs (it is the backward
    kernel again, see the second-order tests below), a backward through it
    raises."""
    x = torch.randn(2, 3, 4, 4, requires_grad=True)
    b = torch.randn(3, requires_grad=True)
    (g,) = torch.autograd.grad(bias_act(x, b, act="lrelu").square().sum(), x, create_graph=True)
    (gg,) = torch.autograd.grad(g.square().sum(), x, create_graph=True)
    assert gg.requires_grad
    with pytest.raises(RuntimeError, match="once_differentiable"):
        gg.sum().backward()


def _jax_second_order(x, b, dy, u, w, act, kw):
    """jax.grad of <(dx, db), (u, w)> for (dx, db) = jax.grad of
    sum(bias_act(x, b) * dy): the gradients of x, b and dy."""
    def first(x, b, dy):
        return jax.grad(lambda x, b: jnp.sum(jax_bias_act(x, b, axis=1, act=act, **kw) * dy),
                        argnums=(0, 1))(x, b)

    def inner(x, b, dy):
        gx, gb = first(x, b, dy)
        return jnp.sum(gx * u) + jnp.sum(gb * w)

    return [np.asarray(g) for g in jax.grad(inner, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(b), jnp.asarray(dy))]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("act,kw", GRAD_CASES, ids=[f"{a}-{k}" for a, k in GRAD_CASES])
def test_bias_act_second_order_matches_jax(act, kw, shape):
    """The Hessian-vector value of the second-order backward against
    jax.grad of jax.grad of the XLA path, on the tie grid (t = 0 and
    y0 = +-clamp occur): g_dy within 1e-6 (fp32, the same products in the
    same order up to one rounding), g_x and g_b zero in both."""
    x, b, dy = _grid_inputs(shape, 21)
    rng = np.random.default_rng(22)
    u = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[1]).astype(np.float32)
    xt, bt, dyt = (torch.from_numpy(a).requires_grad_() for a in (x, b, dy))
    gx, gb = torch.autograd.grad(bias_act(xt, bt, act=act, **kw), (xt, bt), dyt,
                                 create_graph=True)
    got = torch.autograd.grad((gx * torch.from_numpy(u)).sum() + (gb * torch.from_numpy(w)).sum(),
                              (xt, bt, dyt), allow_unused=True)
    want_x, want_b, want_dy = _jax_second_order(x, b, dy, u, w, act, kw)
    assert got[0] is None and got[1] is None
    assert not want_x.any() and not want_b.any()
    np.testing.assert_allclose(got[2].numpy(), want_dy, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bias_act_gradgradcheck_float64(shape):
    """torch.autograd.gradgradcheck in float64, away from kinks: the second
    order with both incoming gradients (g_dx and g_db)."""
    gen = torch.Generator().manual_seed(23)
    x = torch.randn(shape, dtype=torch.float64, generator=gen).requires_grad_()
    b = torch.randn(shape[1], dtype=torch.float64, generator=gen).requires_grad_()
    for act, kw in (("lrelu", dict()), ("relu", dict(clamp=1.0)), ("linear", dict(gain=3.0))):
        assert torch.autograd.gradgradcheck(lambda x, b: bias_act(x, b, act=act, **kw), (x, b))


def test_bias_act_second_order_is_the_backward_kernel_with_dy_add():
    """On the CPU the second order is bias_act_grad_plain with dy = g_dx and
    dy_add = g_db, bit for bit (the kernel's call on the card)."""
    x, b, dy = _grid_inputs((2, 5, 4, 3), 24)
    rng = np.random.default_rng(25)
    u = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(x.shape[1]).astype(np.float32))
    xt, bt, dyt = (torch.from_numpy(a).requires_grad_() for a in (x, b, dy))
    gx, gb = torch.autograd.grad(bias_act(xt, bt, act="lrelu", clamp=1.0), (xt, bt), dyt,
                                 create_graph=True)
    (g_dy,) = torch.autograd.grad((gx * u).sum() + (gb * w).sum(), dyt)
    want, db = bias_act_grad_plain(torch.from_numpy(x), torch.from_numpy(b), u, act="lrelu",
                                   gain=2.0 ** 0.5, clamp=1.0, need_db=False, dy_add=w)
    assert db is None and torch.equal(g_dy, want)


def test_bias_act_grad_plain_is_the_cpu_backward():
    """The Function's CPU backward is bias_act_grad_plain, bit for bit."""
    x, b, dy = _grid_inputs((2, 5, 4, 3), 16)
    kw = dict(act="lrelu", alpha=None, gain=2.0 ** 0.5, clamp=1.0)
    gx, gb = _torch_grads(x, b, dy, "lrelu", dict(clamp=1.0))
    dx, db = bias_act_grad_plain(torch.from_numpy(x), torch.from_numpy(b),
                                 torch.from_numpy(dy), **kw)
    assert torch.equal(gx, dx) and torch.equal(gb, db)


# --------------------------------- upfirdn2d -------------------------------- #

# The generator's two FIR calls: after each up-conv (pad 1) and the skip
# image's upsample2d (up 2); their adjoints are (4 taps, pad 2) and
# (4 taps, down 2, pad 1).
PATH_CASES = [((2, 3, 9, 9), dict(up=1, down=1, padding=1, gain=4.0)),
              ((2, 3, 4, 4), dict(up=2, down=1, padding=(2, 1, 2, 1), gain=4.0))]
ALL_CASES = PATH_CASES + [((2, 3, 12, 8), c) for c in UPFIRDN_CASES]


@pytest.mark.parametrize("shape,case", ALL_CASES, ids=[f"{s}-{c}" for s, c in ALL_CASES])
def test_upfirdn2d_grad_matches_jax_vjp(shape, case):
    """The adjoint against jax.vjp of the JAX XLA path, and <y, A x> =
    <A^T y, x>; 1e-5."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal(shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    f = setup_filter(F1D)
    y = upfirdn2d(xt, f, **case)
    dy = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    y.backward(torch.from_numpy(dy))
    _, vjp = jax.vjp(lambda v: jax_upfirdn2d(v, jax_setup_filter(F1D), **case),
                     jnp.asarray(x.transpose(0, 2, 3, 1)))
    (want,) = vjp(jnp.asarray(dy.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)
    lhs = float((y.detach().double() * torch.from_numpy(dy).double()).sum())
    rhs = float((torch.from_numpy(x).double() * xt.grad.double()).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=1e-5)


def test_upfirdn2d_adjoint_geometry_of_the_path():
    """The adjoints of the path's two FIR calls: pad 2 (same size back) and a
    down-2 FIR with pad 1, for every resolution of a 256² pyramid."""
    f = setup_filter(F1D)
    for r in (8, 16, 32, 64, 128, 256):
        assert adjoint_padding((8, 64, r + 1, r + 1), (8, 64, r, r), f, padding=1) == (2, 2, 2, 2)
        assert adjoint_padding((8, 3, r // 2, r // 2), (8, 3, r, r), f, up=2,
                               padding=(2, 1, 2, 1)) == (1, 1, 1, 1)


def test_upfirdn2d_grad_is_linear_to_every_order():
    """The backward calls the same Function, so gradgradcheck passes (in its
    fast mode, random projections of the Jacobians: the slow mode runs
    thousands of tiny convolutions, which crawl when test workers share the
    cores)."""
    gen = torch.Generator().manual_seed(18)
    f = setup_filter(F1D).double()
    for shape, case in PATH_CASES:
        x = torch.randn(shape, dtype=torch.float64, generator=gen).requires_grad_()
        assert torch.autograd.gradgradcheck(lambda v: upfirdn2d(v, f, **case), (x,),
                                            fast_mode=True)


# --------------------------- conv2d_resample, modulated ----------------------- #


@pytest.mark.parametrize("up,flip_weight", [(2, False), (1, True)], ids=["upconv", "conv"])
def test_conv2d_resample_grads_match_jax_vjp(up, flip_weight):
    """Gradients for x and w at the synthesis layer's up-conv and plain conv
    (3x3, pad 1); 1e-4 of the gradient's scale (summation orders differ)."""
    rng = np.random.default_rng(19)
    x = rng.standard_normal((2, 6, 6, 5)).astype(np.float32)
    w = rng.standard_normal((3, 3, 5, 4)).astype(np.float32)
    f, jf = (setup_filter(F1D), jax_setup_filter(F1D)) if up > 1 else (None, None)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_()
    y = conv2d_resample(xt, wt, f=f, up=up, padding=1, flip_weight=flip_weight)
    dy = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    y.backward(torch.from_numpy(dy))
    _, vjp = jax.vjp(lambda a, b: jax_conv2d_resample(a, b, f=jf, up=up, padding=1,
                                                      flip_weight=flip_weight),
                     jnp.asarray(x), jnp.asarray(w))
    gx, gw = vjp(jnp.asarray(dy.transpose(0, 2, 3, 1)))
    gx, gw = np.asarray(gx).transpose(0, 3, 1, 2), np.asarray(gw).transpose(3, 2, 0, 1)
    np.testing.assert_allclose(xt.grad.numpy(), gx, atol=1e-4 * np.abs(gx).max())
    np.testing.assert_allclose(wt.grad.numpy(), gw, atol=1e-4 * np.abs(gw).max())


@pytest.mark.parametrize("up,demodulate", [(2, True), (1, True), (1, False)])
def test_modulated_conv2d_grads_match_jax_vjp(up, demodulate):
    """Gradients for x, w and the styles, with noise, as in the synthesis
    layers (demodulated, up 2 or 1) and ToRGB (not demodulated); 1e-4."""
    rng = np.random.default_rng(20)
    x = rng.standard_normal((2, 6, 6, 8)).astype(np.float32)
    w = rng.standard_normal((3, 3, 8, 5)).astype(np.float32)
    s = (rng.standard_normal((2, 8)) + 1).astype(np.float32)
    noise = rng.standard_normal((2, 6 * up, 6 * up, 1)).astype(np.float32)
    kw = dict(up=up, padding=1, demodulate=demodulate, flip_weight=(up == 1))
    f, jf = (setup_filter(F1D), jax_setup_filter(F1D)) if up > 1 else (None, None)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_()
    st = torch.from_numpy(s).requires_grad_()
    y = modulated_conv2d(xt, wt, st, noise=torch.from_numpy(noise.transpose(0, 3, 1, 2).copy()),
                         resample_filter=f, **kw)
    dy = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    y.backward(torch.from_numpy(dy))
    _, vjp = jax.vjp(lambda a, b, c: jax_modulated_conv2d(a, b, c, noise=jnp.asarray(noise),
                                                          resample_filter=jf, **kw),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(s))
    gx, gw, gs = vjp(jnp.asarray(dy.transpose(0, 2, 3, 1)))
    for got, want in ((xt.grad, np.asarray(gx).transpose(0, 3, 1, 2)),
                      (wt.grad, np.asarray(gw).transpose(3, 2, 0, 1)), (st.grad, np.asarray(gs))):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max())


# (kernel size, up, down, flip_weight): the discriminator's conv1 (3x3, FIR
# pad 2, stride 2) and skip (1x1, FIR pad 1, stride 2), and the generator's
# up-conv (3x3, up 2, then the FIR).
SECOND_ORDER_CONVS = [(3, 1, 2, True), (1, 1, 2, True), (3, 2, 1, False)]


@pytest.mark.parametrize("k,up,down,flip_weight", SECOND_ORDER_CONVS,
                         ids=["d-conv1", "d-skip", "g-upconv"])
def test_second_order_through_conv2d_resample_matches_jax(k, up, down, flip_weight):
    """An R1-shaped penalty through both kernels: gx = d/dx sum(bias_act(
    conv2d_resample(x, w), b, lrelu) * dy), then the gradients of sum(gx^2)
    for w and b against jax.grad of jax.grad; the FIRs' backward is their
    adjoint through the same Function, bias_act's second order the backward
    kernel; b's is zero in both. 1e-4 of the gradient's scale (summation
    orders differ)."""
    rng = np.random.default_rng(26)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    w = rng.standard_normal((k, k, 4, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    jf, f = jax_setup_filter(F1D), setup_filter(F1D)
    kw = dict(up=up, down=down, padding=k // 2, flip_weight=flip_weight)
    out = 8 * up // down
    dy = rng.standard_normal((2, out, out, 5)).astype(np.float32)

    def jax_penalty(w, b):
        def loss(x):
            y = jax_conv2d_resample(x, w, f=jf, **kw)
            return jnp.sum(jax_bias_act(y, b, act="lrelu") * dy)
        return jnp.sum(jnp.square(jax.grad(loss)(jnp.asarray(x))))

    want_w, want_b = jax.grad(jax_penalty, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(b))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = bias_act(conv2d_resample(xt, wt, f=f, **kw), bt, act="lrelu")
    (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(dy.transpose(0, 3, 1, 2).copy()),
                                create_graph=True)
    got_w, got_b = torch.autograd.grad(gx.square().sum(), (wt, bt), allow_unused=True)
    want_w = np.asarray(want_w).transpose(3, 2, 0, 1)
    np.testing.assert_allclose(got_w.numpy(), want_w, atol=1e-4 * np.abs(want_w).max())
    # gx meets b only through act'(x + b), piecewise constant: no gradient.
    assert got_b is None and not np.asarray(want_b).any()
