"""The port's ops (viscoin_tpu_torch.ops) against the JAX package's.

Inputs come from seeded numpy and pass between the frameworks as numpy.
On the CPU the port's wrappers run their plain torch versions; the JAX side
runs both its XLA path and, where it has one, its Pallas kernel in interpret
mode (as the JAX package's own tests run it). The CUDA kernels themselves
are compared with the plain versions on the card by
``tests/test_torch_gpu.py`` and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from viscoin_tpu.ops.bias_act import bias_act as jax_bias_act
from viscoin_tpu.ops import conv2d_resample as jax_conv2d_resample
from viscoin_tpu.ops import modulated_conv2d as jax_modulated_conv2d
from viscoin_tpu.ops import setup_filter as jax_setup_filter
from viscoin_tpu.ops import upfirdn2d as jax_upfirdn2d
from viscoin_tpu.ops.upfirdn2d import downsample2d as jax_downsample2d
from viscoin_tpu.ops.upfirdn2d import upfirdn2d_ref as jax_upfirdn2d_ref
from viscoin_tpu.ops.upfirdn2d import upsample2d as jax_upsample2d
from viscoin_tpu.ops.upfirdn2d_pallas import upfirdn2d_pallas as jax_upfirdn2d_pallas
from viscoin_tpu_torch.ops import (
    bias_act,
    conv2d_resample,
    downsample2d,
    modulated_conv2d,
    setup_filter,
    upfirdn2d,
    upsample2d,
)
from viscoin_tpu_torch.ops.bias_act import activation_funcs, bias_act_plain
from viscoin_tpu_torch.ops.upfirdn2d import upfirdn2d_plain, upfirdn2d_ref

F1D = [1.0, 3.0, 3.0, 1.0]


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).numpy()


# --------------------------------- bias_act --------------------------------- #

BIAS_ACT_CASES = [
    dict(act=act) for act in activation_funcs
] + [
    dict(act="lrelu", gain=0.5, clamp=0.3),
    dict(act="lrelu", alpha=0.05),
    dict(act="relu", clamp=-1.0),        # a negative clamp means no clamp
    dict(act="linear", gain=3.0, clamp=2.0),
    dict(act="swish", gain=1.0, clamp=0.5),
]


@pytest.mark.parametrize("case", BIAS_ACT_CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_bias_act_matches_jax(case):
    """fp32, NCHW with the bias on dim 1; JAX takes the same array with
    axis=1. Tolerance 1e-6: the same fp32 elementwise ops."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 5, 4, 3)) * 2).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    got = bias_act(torch.from_numpy(x), torch.from_numpy(b), **case).numpy()
    want = np.asarray(jax_bias_act(jnp.asarray(x), jnp.asarray(b), axis=1, **case))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if case["act"] in ("linear", "relu", "lrelu"):
        pallas = np.asarray(jax_bias_act(jnp.asarray(x), jnp.asarray(b), axis=1,
                                         impl="pallas", **case))
        np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)


def test_bias_act_rank2_and_no_bias():
    """(B, F) features (FullyConnected) and the mapping's bias-free
    (B, n, w_dim) call, against the JAX Pallas kernel; 1e-6."""
    rng = np.random.default_rng(2)
    x2 = rng.standard_normal((3, 7)).astype(np.float32)
    b2 = rng.standard_normal(7).astype(np.float32)
    got = bias_act(torch.from_numpy(x2), torch.from_numpy(b2), act="lrelu").numpy()
    want = np.asarray(jax_bias_act(jnp.asarray(x2), jnp.asarray(b2), act="lrelu",
                                   impl="pallas"))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    x3 = rng.standard_normal((2, 4, 6)).astype(np.float32)
    got = bias_act(torch.from_numpy(x3), None, act="lrelu").numpy()
    want = np.asarray(jax_bias_act(jnp.asarray(x3), None, act="lrelu", impl="pallas"))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_bias_act_defaults_and_bf16():
    """def_gain is the default gain; the plain version computes in fp32 and
    rounds once to bf16 (what the kernel does)."""
    x = torch.linspace(-3, 3, 24).reshape(2, 3, 4)
    np.testing.assert_allclose(bias_act(x, act="relu").numpy(),
                               (torch.relu(x) * np.sqrt(2.0)).numpy(), rtol=1e-6)
    b = torch.tensor([0.5, -0.25, 1.0])
    got = bias_act_plain(x.bfloat16(), b, act="lrelu", gain=1.3, clamp=2.0)
    assert got.dtype == torch.bfloat16
    want = bias_act_plain(x.bfloat16().float(), b.bfloat16().float(), act="lrelu",
                          gain=1.3, clamp=2.0).bfloat16()
    assert torch.equal(got, want)


# --------------------------------- upfirdn2d -------------------------------- #

UPFIRDN_CASES = [
    # (up, down, padding, gain): the five configurations of the JAX Pallas
    # kernel's own test, then the main path's valid blur after the up-conv.
    dict(up=2, down=1, padding=(3, 2, 3, 2), gain=4.0),
    dict(up=2, down=1, padding=(2, 1, 2, 1), gain=4.0),
    dict(up=1, down=2, padding=(1, 1, 1, 1), gain=1.0),
    dict(up=1, down=1, padding=2, gain=1.0),
    dict(up=1, down=1, padding=(-1, 2, 0, -2), gain=1.0),
    dict(up=1, down=1, padding=0, gain=4.0),
]


@pytest.mark.parametrize("case", UPFIRDN_CASES, ids=str)
def test_upfirdn2d_matches_jax(case):
    """Separable [1,3,3,1] taps: the port (NCHW) against the JAX Pallas
    kernel, the JAX XLA path and the numpy oracle (NHWC); 1e-5."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 12, 8)).astype(np.float32)
    got = _nhwc(upfirdn2d(_nchw(x), setup_filter(F1D), **case))
    pallas = np.asarray(jax_upfirdn2d_pallas(jnp.asarray(x), F1D, **case))
    xla = np.asarray(jax_upfirdn2d(jnp.asarray(x), jax_setup_filter(F1D), **case))
    oracle = jax_upfirdn2d_ref(x, np.asarray(jax_setup_filter(F1D)), **case)
    assert got.shape == pallas.shape == xla.shape == oracle.shape
    for want in (pallas, xla, oracle):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("flip", [False, True])
def test_upfirdn2d_asymmetric_taps(flip):
    """Asymmetric taps, with and without flip_filter; 1e-5."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 10, 10, 4)).astype(np.float32)
    taps = [1.0, 2.0, 4.0, 8.0]
    kw = dict(up=2, padding=(3, 2, 3, 2), gain=4.0, flip_filter=flip)
    got = _nhwc(upfirdn2d(_nchw(x), setup_filter(taps), **kw))
    want = np.asarray(jax_upfirdn2d_pallas(jnp.asarray(x), taps, **kw))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want = np.asarray(jax_upfirdn2d(jnp.asarray(x), jax_setup_filter(taps), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_upfirdn2d_odd_channels_and_2d_filter():
    """An odd channel count through the separable path, and a 2-D
    (non-separable) filter, which stays on the plain path; 1e-5."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 6, 7, 3)).astype(np.float32)
    got = _nhwc(upfirdn2d(_nchw(x), setup_filter(F1D), up=2, padding=(2, 1, 2, 1), gain=4.0))
    want = np.asarray(jax_upfirdn2d_pallas(jnp.asarray(x), F1D, up=2,
                                           padding=(2, 1, 2, 1), gain=4.0))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    f2 = rng.standard_normal((3, 2)).astype(np.float32)
    got = _nhwc(upfirdn2d(_nchw(x), torch.from_numpy(f2), up=(2, 1), down=(1, 2),
                          padding=(1, 0, 2, 1)))
    want = upfirdn2d_ref(x, f2, up=(2, 1), down=(1, 2), padding=(1, 0, 2, 1))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_setup_filter_and_resample_helpers():
    """setup_filter's separable taps describe the JAX 2-D filter;
    upsample2d / downsample2d keep the reference padding conventions."""
    f = setup_filter(F1D, gain=4.0)
    np.testing.assert_allclose(torch.outer(f, f).numpy(),
                               np.asarray(jax_setup_filter(F1D, gain=4.0)), rtol=1e-6)
    f2 = setup_filter(np.outer(F1D, F1D), flip_filter=True)
    np.testing.assert_allclose(f2.numpy(), np.asarray(jax_setup_filter(F1D, flip_filter=True)),
                               rtol=1e-6)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 6, 6, 3)).astype(np.float32)
    got = _nhwc(upsample2d(_nchw(x), setup_filter(F1D)))
    want = np.asarray(jax_upsample2d(jnp.asarray(x), jax_setup_filter(F1D)))
    assert got.shape == (2, 12, 12, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    got = _nhwc(downsample2d(_nchw(x), setup_filter(F1D)))
    want = np.asarray(jax_downsample2d(jnp.asarray(x), jax_setup_filter(F1D)))
    assert got.shape == (2, 3, 3, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------- conv2d_resample / modulated ----------------------- #


@pytest.mark.parametrize("up,k,flip_weight", [(2, 3, False), (2, 3, True), (2, 1, True),
                                              (1, 3, True), (1, 1, True), (1, 3, False)])
def test_conv2d_resample_matches_jax(up, k, flip_weight):
    """The up path (conv_transpose2d + FIR) and the stride-1 path against the
    JAX lhs-dilated conv, in fp32; 1e-4 (summation order differs)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 7, 6, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 4)).astype(np.float32)  # HWIO
    f = setup_filter(F1D) if up > 1 else None
    jf = jax_setup_filter(F1D) if up > 1 else None
    got = _nhwc(conv2d_resample(_nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                                f=f, up=up, padding=k // 2, flip_weight=flip_weight))
    want = np.asarray(jax_conv2d_resample(jnp.asarray(x), jnp.asarray(w), f=jf, up=up,
                                          padding=k // 2, flip_weight=flip_weight))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_conv2d_resample_down_and_asymmetric_padding():
    """The down path (FIR then strided conv) and an asymmetric, partly
    negative padding folded into the stride-1 conv; 1e-4."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    got = _nhwc(conv2d_resample(_nchw(x), wt, f=setup_filter(F1D), down=2, padding=1))
    want = np.asarray(jax_conv2d_resample(jnp.asarray(x), jnp.asarray(w),
                                          f=jax_setup_filter(F1D), down=2, padding=1))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    got = _nhwc(conv2d_resample(_nchw(x), wt, padding=(2, -1, 0, 1)))
    want = np.asarray(jax_conv2d_resample(jnp.asarray(x), jnp.asarray(w),
                                          padding=(2, -1, 0, 1)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("up,demodulate", [(1, True), (2, True), (1, False)])
def test_modulated_conv2d_matches_jax(up, demodulate):
    """fp32, with noise and demodulation; 1e-4."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 6, 6, 8)).astype(np.float32)
    w = rng.standard_normal((3, 3, 8, 5)).astype(np.float32)
    s = (rng.standard_normal((2, 8)) + 1).astype(np.float32)
    ho = 6 * up
    noise = rng.standard_normal((2, ho, ho, 1)).astype(np.float32)
    kw = dict(up=up, padding=1, demodulate=demodulate, flip_weight=(up == 1))
    got = _nhwc(modulated_conv2d(
        _nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), torch.from_numpy(s),
        noise=_nchw(noise), resample_filter=setup_filter(F1D) if up > 1 else None, **kw))
    want = np.asarray(jax_modulated_conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), noise=jnp.asarray(noise),
        resample_filter=jax_setup_filter(F1D) if up > 1 else None, **kw))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_modulated_conv2d_bf16_branch():
    """bf16 takes the pre-normalisation of w and styles (which demodulation
    cancels): the port in bf16 against JAX in bf16, and both against fp32.
    Tolerances are bf16's: 3e-2 relative to the output scale."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 5, 5, 8)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 8, 4)) * 7).astype(np.float32)
    s = (rng.standard_normal((2, 8)) * 5).astype(np.float32)
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    got = _nhwc(modulated_conv2d(_nchw(x).bfloat16(), wt, torch.from_numpy(s),
                                 padding=1).float())
    want = np.asarray(jax_modulated_conv2d(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                                           jnp.asarray(s), padding=1).astype(jnp.float32))
    ref32 = _nhwc(modulated_conv2d(_nchw(x), wt, torch.from_numpy(s), padding=1))
    scale = np.abs(ref32).max()
    np.testing.assert_allclose(got, want, atol=3e-2 * scale)
    np.testing.assert_allclose(got, ref32, atol=3e-2 * scale)


def test_plain_upfirdn2d_is_the_cpu_path():
    """On a CPU tensor the wrapper's result is the plain version's, bit for bit."""
    x = torch.randn(1, 2, 5, 5, generator=torch.Generator().manual_seed(0))
    f = setup_filter(F1D)
    assert torch.equal(upfirdn2d(x, f, up=2, padding=(2, 1, 2, 1), gain=4.0),
                       upfirdn2d_plain(x, f, up=2, padding=(2, 1, 2, 1), gain=4.0))
