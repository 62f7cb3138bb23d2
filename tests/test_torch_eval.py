"""The port's eval against the JAX package's, on the CPU, on the toy bundle
of tests/torch_port_helpers.py with perturbed weights and perturbed LPIPS:
the test step's masked sums and ``test_viscoin`` over a ragged loader (rtol
1e-4), the faithfulness probe (atol 1e-5), ``amplify_concepts`` with the same
selection and rng (probabilities atol 1e-5, images atol 1e-4), the FID
statistics, and the engine's ``amplify`` and ``/v1/amplify`` against the JAX
engine."""

import io
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import (IMG, NC, NK, images, jax_bundle, nchw, perturb, run_once,
                                torch_bundle)
from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from viscoin_tpu.data.datasets import SyntheticDataset as JSynthetic
from viscoin_tpu.data.loader import DataLoader as JLoader
from viscoin_tpu.data.transforms import device_preprocess as jax_preprocess
from viscoin_tpu.eval import fid as JF
from viscoin_tpu.eval import viscoin as JE
from viscoin_tpu.models.lpips import LPIPS
from viscoin_tpu.serve.engine import InferenceEngine as JaxInferenceEngine
from viscoin_tpu_torch.data.datasets import SyntheticDataset
from viscoin_tpu_torch.data.loader import DataLoader
from viscoin_tpu_torch.data.transforms import device_preprocess
from viscoin_tpu_torch.eval import fid as TF
from viscoin_tpu_torch.eval import viscoin as TE
from viscoin_tpu_torch.models.lpips import LPIPS as TLPIPS
from viscoin_tpu_torch.serve.engine import InferenceEngine
from viscoin_tpu_torch.serve.server import VisCoINServer
from viscoin_tpu_torch.utils.weights import load_jax_tree

SELECTIONS = [{"method": "top_k", "k": 3}, {"method": "threshold", "threshold": 0.2},
              {"method": "indices", "indices": [1, 5]}]
MULTIPLIERS = [0.0, 1.0, 2.0, 4.0]


@pytest.fixture(scope="module")
def setup():
    """JAX bundle + perturbed LPIPS, their port twins, and the JAX test step
    (jitted once)."""
    jm = jax_bundle(seed=3)
    x = jnp.zeros((1, 16, 16, 3))  # LPIPS's parameter shapes do not depend on the size
    lparams = perturb(run_once(LPIPS().init, jax.random.PRNGKey(4), x, x)["params"], 5)
    lparams = jax.tree_util.tree_map(np.abs, lparams)  # the heads are non-negative
    tm = torch_bundle(jm)
    tl = load_jax_tree(TLPIPS(device="cpu"), {"params": lparams}).eval()
    jstep = JE.make_test_step(jm, LPIPS())
    return jm, lparams, jstep, tm, tl


@pytest.fixture(scope="module")
def jax_amplify_fns(setup):
    """JAX's amplify functions, jitted once for every test (M = 4)."""
    return JE.make_amplify_fns(setup[0])


def _close(got, want, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def test_test_step_sums_match_jax(setup):
    jm, lparams, jstep, tm, tl = setup
    u8 = images(4, seed=11)
    labels = np.array([0, 3, 4, 1])
    valid = np.array([1, 1, 1, 0], np.float32)
    want, wrebuilt, wx = jstep(JE._bundle_variables(jm), lparams, jnp.asarray(u8),
                               jnp.asarray(labels), jnp.asarray(valid))
    got, rebuilt, x = TE.make_test_step(tm, tl)(torch.from_numpy(u8), torch.from_numpy(labels),
                                                torch.from_numpy(valid))
    assert set(got) == set(want) == set(TE.METRIC_KEYS)
    for k in want:
        _close(float(got[k]), float(want[k]))
    _close(rebuilt.permute(0, 2, 3, 1).numpy(), wrebuilt)
    _close(x.permute(0, 2, 3, 1).numpy(), wx)


def test_test_viscoin_ragged_loader_matches_jax(setup):
    """5 test images in batches of 4: the last batch is padded and masked."""
    jm, lparams, jstep, tm, tl = setup
    jl = JLoader(JSynthetic(n=5, n_classes=NC, image_size=IMG, mode="test"), 4,
                 shuffle=False, num_threads=0)
    tloader = DataLoader(SyntheticDataset(n=5, n_classes=NC, image_size=IMG, mode="test"), 4,
                         shuffle=False, num_threads=0)
    want = JE.test_viscoin(jm, LPIPS(), lparams, jl, verbose=False, step=jstep)
    got = TE.test_viscoin(tm, tl, tloader, verbose=False)
    assert got.__dict__.keys() == want.__dict__.keys()
    for k, v in want.__dict__.items():
        if v is None:
            assert getattr(got, k) is None
        else:
            _close(getattr(got, k), v)


def test_test_viscoin_fid_path(setup):
    """With a detector, FID from the host-side statistics of the valid rows
    only (the padded row is sliced off), as the JAX host path computes it."""
    jm, lparams, jstep, tm, tl = setup
    proj = np.random.default_rng(0).standard_normal((3 * IMG * IMG, 6)).astype(np.float32)

    def jdet(x):
        return np.asarray(x).reshape(x.shape[0], -1) @ proj

    def tdet(x):
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).numpy() @ proj

    jl = JLoader(JSynthetic(n=7, n_classes=NC, image_size=IMG, mode="test"), 4,
                 shuffle=False, num_threads=0)
    tloader = DataLoader(SyntheticDataset(n=7, n_classes=NC, image_size=IMG, mode="test"), 4,
                         shuffle=False, num_threads=0)
    want = JE.test_viscoin(jm, LPIPS(), lparams, jl, compute_fid=True, fid_detector=jdet,
                           step=jstep)
    got = TE.test_viscoin(tm, tl, tloader, compute_fid=True, fid_detector=tdet)
    _close(got.fid_score, want.fid_score, rtol=1e-3, atol=1e-3)


def test_faithfulness_probe_matches_jax(setup):
    """40 images: one full chunk of 32 and one padded chunk of 8."""
    jm, _, _, tm, _ = setup
    u8 = images(40, seed=12)
    want = JE.faithfulness_probe(jm, u8)
    got = TE.faithfulness_probe(tm, u8)
    assert got.shape == want.shape == (40,)
    _close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("selection", SELECTIONS, ids=lambda s: s["method"])
def test_amplify_concepts_matches_jax(setup, jax_amplify_fns, selection):
    jm, _, _, tm, _ = setup
    u8 = images(1, seed=13)
    jx = jax_preprocess(jnp.asarray(u8))[0]
    tx = device_preprocess(torch.from_numpy(u8))[0]
    want = JE.amplify_concepts(jx, jm, selection, MULTIPLIERS, rng=np.random.default_rng(2),
                               fns=jax_amplify_fns)
    got = TE.amplify_concepts(tx, tm, selection, MULTIPLIERS, rng=np.random.default_rng(2))
    _close(got.image, want.image, rtol=0, atol=1e-6)
    _close(got.default_probas, want.default_probas, rtol=0, atol=1e-5)
    _close(got.best_concept_probas_best, want.best_concept_probas_best, rtol=0, atol=1e-5)
    _close(got.best_concept_probas_rand, want.best_concept_probas_rand, rtol=0, atol=1e-5)
    assert got.multipliers == want.multipliers
    assert len(got.amplified_images) == len(MULTIPLIERS)
    for g, w in zip(got.amplified_images, want.amplified_images):
        assert g.shape == (IMG, IMG, 3)
        _close(g, w, rtol=0, atol=1e-4)
    specific = TE.amplify_specific_concepts(tx, tm, [1, 5], MULTIPLIERS)
    want_specific = JE.amplify_specific_concepts(jx, jm, [1, 5], MULTIPLIERS,
                                                 fns=jax_amplify_fns)
    for g, w in zip(specific, want_specific):
        _close(g, w, rtol=0, atol=1e-4)


def test_fid_statistics_match_jax():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((50, 6)), rng.standard_normal((40, 6)) * 1.3 + 0.2
    stats = []
    for mod in (TF, JF):
        real, fake = mod.FeatureStats(), mod.FeatureStats(max_items=35)
        real.append(a[:20])
        real.append(a[20:])
        fake.append(b)
        stats.append((real, fake))
    (tr, tf), (jr, jf) = stats
    assert tf.num_items == jf.num_items == 35
    _close(TF.fid_from_stats(tr, tf), JF.fid_from_stats(jr, jf), rtol=0, atol=1e-5)
    moments = TF.FeatureStats()
    moments.append_moments(a.sum(0), a.T @ a, len(a))
    for g, w in zip(moments.get_mean_cov(), tr.get_mean_cov()):
        _close(g, w, rtol=0, atol=1e-10)


def test_engine_amplify_and_http_match_jax(setup, jax_amplify_fns):
    """The engine's amplify (an arbitrary-size image, resized with the eval
    geometry) and POST /v1/amplify against the JAX engine's amplify."""
    jm, _, _, tm, _ = setup
    img = images(1, size=45, seed=14)[0]
    jeng = JaxInferenceEngine(jm, batch_size=2)
    jeng._amplify_fns = jax_amplify_fns  # compiled once for the module
    teng = InferenceEngine(tm, batch_size=2, device="cpu")
    sel = {"method": "top_k", "k": 2}
    want = jeng.amplify(img, sel, MULTIPLIERS, seed=5)
    got = teng.amplify(img, sel, MULTIPLIERS, seed=5)
    _close(got.best_concept_probas_best, want.best_concept_probas_best, rtol=0, atol=1e-5)
    _close(got.best_concept_probas_rand, want.best_concept_probas_rand, rtol=0, atol=1e-5)
    for g, w in zip(got.amplified_images, want.amplified_images):
        _close(g, w, rtol=0, atol=1e-4)

    vs = VisCoINServer(teng, max_delay_ms=2.0)
    httpd = vs.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        buf = io.BytesIO()
        np.savez(buf, images=img)
        url = (f"http://127.0.0.1:{httpd.server_address[1]}/v1/amplify"
               "?multipliers=0,1,2,4&top_k_concepts=2&seed=5")
        req = urllib.request.Request(url, data=buf.getvalue(),
                                     headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = np.load(io.BytesIO(r.read()))
        _close(out["probas_best"], want.best_concept_probas_best, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(out["multipliers"], MULTIPLIERS)
        from viscoin_tpu.data.transforms import denormalize

        want_u8 = (np.clip(np.asarray(denormalize(jnp.asarray(np.stack(
            want.amplified_images)))), 0, 1) * 255).round().astype(np.uint8)
        assert out["amplified_u8"].shape == (4, IMG, IMG, 3)
        assert np.abs(out["amplified_u8"].astype(int) - want_u8.astype(int)).max() <= 1
        req = urllib.request.Request(url, data=io.BytesIO().getvalue())
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        vs.close()
        thread.join(10)


def test_eval_runs_on_the_bundles_device_and_dtype(setup):
    """A bf16 bundle (as the bf16 engine holds it) evaluates in bf16 and
    returns fp32 probabilities; the probe's chunk size is fixed."""
    _, _, _, tm, tl = setup
    import copy

    bm = copy.deepcopy(tm).to(torch.bfloat16)
    probs = TE.faithfulness_probe(bm, images(3, seed=15), batch_size=2)
    assert probs.dtype == np.float32 and probs.shape == (3,) and np.isfinite(probs).all()
    calls = []
    fn = TE.make_faithfulness_fn(tm)
    TE.faithfulness_probe(tm, images(5, seed=16), batch_size=4,
                          fn=lambda x: calls.append(x.shape[0]) or fn(x))
    assert calls == [4, 4]
    assert nchw(images(1)).shape == (1, 3, IMG, IMG) and NK == 8
