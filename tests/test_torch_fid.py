"""FID, KID and precision/recall of the PyTorch port (``viscoin_tpu_torch/eval/fid.py``)
and the in-loop FID statistics of ``train gan`` (``train/gan.py``) against
the JAX package's:

  * on the same features, FID, KID and precision/recall within 1e-10
    relative (both are float64 / float32 numpy on the host);
  * ``accumulate_real_fid_stats`` over the same synthetic dataset and
    ``accumulate_fake_fid_stats`` with JAX's latents replayed (noise
    strengths 0, so the synthesis noise, drawn differently by design, does
    not enter), through the same linear detector: moments within 1e-5 (the
    images are float32 in two frameworks).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_gan import G_KW, jax_nets
from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from viscoin_tpu.data.datasets import SyntheticDataset as JSyntheticDataset
from viscoin_tpu.eval import fid as jfid
from viscoin_tpu.train import gan as jgan
from viscoin_tpu_torch.data.datasets import SyntheticDataset
from viscoin_tpu_torch.eval import fid as tfid
from viscoin_tpu_torch.models import stylegan as tsg
from viscoin_tpu_torch.train import gan as tgan
from viscoin_tpu_torch.train.viscoin import fold_seed
from viscoin_tpu_torch.utils.weights import load_jax_tree

B, IMG = 4, 16


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-300)


def _stats(module, real: np.ndarray, fake: np.ndarray):
    out = []
    for x in (real, fake):
        s = module.FeatureStats(capture_all=True)
        for i in range(0, len(x), 7):  # in batches, as the loops append
            s.append(x[i: i + 7])
        out.append(s)
    return out


def test_fid_kid_precision_recall_match_jax():
    rng = np.random.default_rng(0)
    real = rng.standard_normal((40, 16)).astype(np.float32)
    fake = (rng.standard_normal((36, 16)) * 1.1 + 0.2).astype(np.float32)
    t_real, t_fake = _stats(tfid, real, fake)
    j_real, j_fake = _stats(jfid, real, fake)
    assert _rel(tfid.fid_from_stats(t_real, t_fake), jfid.fid_from_stats(j_real, j_fake)) <= 1e-10
    assert _rel(tfid.kid_from_stats(t_real, t_fake, num_subsets=20, max_subset_size=30, seed=3),
                jfid.kid_from_stats(j_real, j_fake, num_subsets=20, max_subset_size=30,
                                    seed=3)) <= 1e-10
    got = tfid.pr_from_stats(t_real, t_fake, nhood_size=3)
    want = jfid.pr_from_stats(j_real, j_fake, nhood_size=3)
    assert all(_rel(g, w) <= 1e-10 for g, w in zip(got, want)), (got, want)
    assert 0 < got[0] < 1 or 0 < got[1] < 1  # the fixture tells the manifolds apart
    blocked = tfid.precision_recall(real, fake, 3, row_batch=5)
    assert blocked == jfid.precision_recall(real, fake, 3, row_batch=5) == got
    with pytest.raises(ValueError, match="capture_all"):
        tfid.kid_from_stats(tfid.FeatureStats(), t_fake)
    with pytest.raises(ValueError, match="nhood_size"):
        tfid.precision_recall(real[:3], fake)


def _projection(seed: int = 4) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((IMG * IMG * 3, 8)).astype(np.float32)


def jax_detector(images):  # NHWC
    return images.reshape(images.shape[0], -1) @ jnp.asarray(_projection())


def torch_detector(images):  # NCHW
    x = images.permute(0, 2, 3, 1).reshape(images.shape[0], -1)
    return x @ torch.from_numpy(_projection())


def _assert_moments_close(t, j):
    assert t.num_items == j.num_items
    (tm, tc), (jm, jc) = t.get_mean_cov(), j.get_mean_cov()
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-5 * np.abs(jm).max())
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-5 * np.abs(jc).max())


def test_accumulate_real_fid_stats_matches_jax():
    """The first 8 of 10 training images (batch 4: two full batches; a third
    would overshoot), in order, through each framework's real-image
    conversion."""
    kw = dict(n=10, image_size=IMG, mode="train", transform="gan")
    _, jreal = jgan.make_gan_fid_fns(None, B)
    _, treal = tgan.make_gan_fid_fns(B)
    j = jgan.accumulate_real_fid_stats(jax_detector, jreal, JSyntheticDataset(**kw), B, 8)
    t = tgan.accumulate_real_fid_stats(torch_detector, treal, SyntheticDataset(**kw), B, 8,
                                       device="cpu")
    assert t.num_items == 8
    _assert_moments_close(t, j)


def test_accumulate_fake_fid_stats_matches_jax():
    """10 fakes at batch 4 (three batches, the last cut to 2): the port's
    loop hands batch j the seed fold_seed(base, j); the test feeds it JAX's
    latents of batch j (noise strengths 0 in both generators)."""
    jg, _, gv, _ = jax_nets()

    def zero_noise(path, x):
        return np.zeros_like(x) if "noise_strength" in jax.tree_util.keystr(path) else x

    gv = jax.tree_util.tree_map_with_path(zero_noise, jax.tree_util.tree_map(np.asarray, gv))
    jfake, _ = jgan.make_gan_fid_fns(jg, B)
    base = jax.random.PRNGKey(7)
    j = jgan.accumulate_fake_fid_stats(jax_detector, jfake, gv, base, 10)

    zs = [np.asarray(jax.random.normal(jax.random.split(jax.random.fold_in(base, i))[0],
                                       (B, G_KW["z_dim"]))) for i in range(3)]
    tg = load_jax_tree(tsg.Generator(**G_KW, device="cpu"), gv).eval()
    tfake, _ = tgan.make_gan_fid_fns(B)
    seeds = []

    def replayed(g, seed):
        seeds.append(seed)
        return tfake(g, seed, z=torch.from_numpy(np.array(zs[len(seeds) - 1])))

    t = tgan.accumulate_fake_fid_stats(torch_detector, replayed, tg, 123, 10)
    assert seeds == [fold_seed(123, i) for i in range(3)]
    _assert_moments_close(t, j)
    # Without z the latents come from the seed: the same seed, the same images.
    a, b = tfake(tg, 5), tfake(tg, 5)
    assert torch.equal(a, b) and not torch.equal(a, tfake(tg, 6))
