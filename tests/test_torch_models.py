"""The port's models against the JAX package's modules, at toy widths.

Weights come from the JAX init, are perturbed with seeded numpy values and
go through ``load_jax_variables`` (or ``jax_to_state_dict``); inputs are
seeded numpy. Tolerances are 1e-4 (fp32, different summation orders),
relative to the output scale where activations grow past 1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import NC, NK, jax_bundle, nchw, nhwc, perturb, run_once, torch_bundle
from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from viscoin_tpu.models.stylegan import GeneratorAdapted
from viscoin_tpu.models.stylegan import flatten_concepts as jax_flatten_concepts
from viscoin_tpu_torch.models.stylegan import GeneratorAdapted as TGeneratorAdapted
from viscoin_tpu_torch.models.stylegan import flatten_concepts
from viscoin_tpu_torch.utils.weights import jax_to_state_dict

TOL = 1e-4


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol, atol=tol * scale)


@pytest.fixture(scope="module")
def bundles():
    jm = jax_bundle()
    return jm, torch_bundle(jm)


def test_classifier_matches_jax(bundles):
    jm, tm = bundles
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    logits, hidden = jm.classify(jnp.asarray(x))
    with torch.no_grad():
        tlogits, thidden = tm.classify(nchw(x))
    _close(tlogits.numpy(), logits)
    assert len(thidden) == 5
    for th, h in zip(thidden, hidden):
        assert nhwc(th).shape == np.shape(h)
        _close(nhwc(th), h)


def test_concept_extractor_matches_jax(bundles):
    """7x7 latents (the 224² geometry): adaptive pooling 7 -> 3 and the
    channel-major Phi' flatten."""
    jm, tm = bundles
    rng = np.random.default_rng(1)
    hidden = [rng.standard_normal(s).astype(np.float32)
              for s in ((2, 28, 28, 16), (2, 14, 14, 32), (2, 7, 7, 64))]
    phi, phi_prime = jm.extract_concepts([None, None] + [jnp.asarray(h) for h in hidden])
    with torch.no_grad():
        tphi, tphi_prime = tm.extract_concepts([None, None] + [nchw(h) for h in hidden])
    assert tphi.shape == (2, NK, 3, 3)
    _close(nhwc(tphi), phi)
    _close(tphi_prime.numpy(), phi_prime)


@pytest.mark.parametrize("normalized", [False, True])
def test_explainer_matches_jax(normalized):
    """Both variants; the weight-norm variant keeps the JAX +1e-12."""
    jm = jax_bundle(normalized=normalized)
    tm = torch_bundle(jm, normalized=normalized)
    phi = np.random.default_rng(2).standard_normal((3, 3, 3, NK)).astype(np.float32)
    want = jm.explain(jnp.asarray(phi))
    with torch.no_grad():
        got = tm.explain(nchw(phi))
    assert got.shape == (3, NC)
    _close(got.numpy(), want)


def test_flatten_concepts_order():
    phi = np.arange(2 * 3 * 3 * 4, dtype=np.float32).reshape(2, 3, 3, 4)
    np.testing.assert_array_equal(flatten_concepts(nchw(phi)).numpy(),
                                  np.asarray(jax_flatten_concepts(jnp.asarray(phi))))


@pytest.mark.parametrize("res,channel_base,channel_max", [(16, 512, 32), (32, 256, 16)])
def test_generator_adapted_matches_jax(res, channel_base, channel_max):
    """noise_mode="const", perturbed noise strengths, biases and
    fixed_w_avg: the image and W+ against the JAX module."""
    kw = dict(z_dim=8, w_dim=32, img_resolution=res, channel_base=channel_base,
              channel_max=channel_max)
    g = GeneratorAdapted(**kw)
    rng = np.random.default_rng(res)
    phi = rng.standard_normal((2, 3, 3, 8)).astype(np.float32)
    phi_prime = rng.standard_normal((2, 72)).astype(np.float32)
    v = perturb(run_once(lambda k, a, b: g.init({"params": k}, a, b, noise_mode="const"),
                         jax.random.PRNGKey(0), jnp.asarray(phi), jnp.asarray(phi_prime)), res)
    img, ws = g.apply(v, jnp.asarray(phi), jnp.asarray(phi_prime), return_latents=True,
                      noise_mode="const")

    tg = TGeneratorAdapted(**kw, device="cpu")
    sd = {k.removeprefix("gan."): torch.from_numpy(a)
          for k, a in jax_to_state_dict({"gan": v}).items()}
    tg.load_state_dict(sd, strict=True)
    with torch.no_grad():
        timg, tws = tg(nchw(phi), torch.from_numpy(phi_prime), return_latents=True,
                       noise_mode="const")
        timg_none = tg(nchw(phi), torch.from_numpy(phi_prime), noise_mode="none")
    assert timg.shape == (2, 3, res, res)
    _close(tws.numpy(), ws)
    _close(nhwc(timg), img)
    img_none = g.apply(v, jnp.asarray(phi), jnp.asarray(phi_prime), noise_mode="none")
    _close(nhwc(timg_none), img_none)


def test_generator_random_noise_uses_the_generator():
    """noise_mode="random" draws from the torch.Generator it is given."""
    tg = TGeneratorAdapted(z_dim=4, w_dim=8, img_resolution=8, channel_base=64,
                           channel_max=8, device="cpu")
    from viscoin_tpu_torch.models.bundle import init_models

    init_models(tg, seed=0)
    with torch.no_grad():
        for m in tg.modules():
            if hasattr(m, "noise_strength"):
                m.noise_strength.fill_(0.5)
        phi, phi_prime = torch.randn(1, 4, 3, 3), torch.randn(1, 36)
        a = tg(phi, phi_prime, generator=torch.Generator().manual_seed(1))
        b = tg(phi, phi_prime, generator=torch.Generator().manual_seed(1))
        c = tg(phi, phi_prime, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)


def test_low_res256_post_matches_jax():
    """Centre crop to 384x512 and an antialiased bilinear resize to 256²."""
    x = np.random.default_rng(3).standard_normal((1, 512, 512, 3)).astype(np.float32)
    want = GeneratorAdapted(low_res256=True)._post(jnp.asarray(x))
    got = TGeneratorAdapted(low_res256=True, img_resolution=8, channel_base=64,
                            channel_max=8, w_dim=8, z_dim=4, device="cpu")._post(nchw(x))
    assert got.shape == (1, 3, 256, 256)
    _close(nhwc(got), want, tol=1e-5)
