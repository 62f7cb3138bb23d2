"""The port's serving slice (InferenceEngine on device="cpu", the HTTP
server) against the JAX package's InferenceEngine on the same perturbed
variables and the same seeded u8 images."""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from torch_port_helpers import IMG, NC, NK, images, jax_bundle, torch_bundle
from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from viscoin_tpu.serve.engine import InferenceEngine as JaxInferenceEngine
from viscoin_tpu_torch.serve.engine import InferenceEngine, pad_to_multiple, run_padded
from viscoin_tpu_torch.serve.server import VisCoINServer


@pytest.fixture(scope="module")
def pair():
    jm = jax_bundle()
    return (JaxInferenceEngine(jm, batch_size=4),
            InferenceEngine(torch_bundle(jm), batch_size=4, device="cpu"))


def test_classify_matches_jax_engine(pair):
    """Logits, probabilities and pooled concepts at 1e-4; 6 images through a
    batch-4 engine, so the second chunk is padded."""
    jeng, teng = pair
    imgs = images(6)
    want, got = jeng.classify(imgs), teng.classify(imgs)
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype == np.float32, key
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4, err_msg=key)


def test_reconstruct_matches_jax_engine(pair):
    """u8 reconstructions within one level (the rounding of values that
    land near a half level may differ); predictions equal."""
    jeng, teng = pair
    imgs = images(5, seed=1)
    want, got = jeng.reconstruct(imgs), teng.reconstruct(imgs)
    assert got["reconstruction_u8"].shape == (5, IMG, IMG, 3)
    assert got["reconstruction_u8"].dtype == np.uint8
    diff = np.abs(got["reconstruction_u8"].astype(int) - want["reconstruction_u8"].astype(int))
    assert diff.max() <= 1
    assert 0 < got["reconstruction_u8"].std()
    np.testing.assert_array_equal(got["preds"], want["preds"])
    np.testing.assert_array_equal(got["expl_preds"], want["expl_preds"])


def test_padding_invariance_and_chunking(pair):
    """3 images in one padded batch == each image alone; 9 images in three
    chunks == the same images one chunk at a time."""
    _, teng = pair
    imgs = images(9, seed=2)
    batched = teng.classify(imgs[:3])
    for i in range(3):
        single = teng.classify(imgs[i])
        np.testing.assert_allclose(batched["logits"][i], single["logits"][0],
                                   rtol=1e-5, atol=1e-5)
    whole = teng.classify(imgs)
    parts = [teng.classify(imgs[s:s + 4]) for s in (0, 4, 8)]
    np.testing.assert_allclose(whole["logits"],
                               np.concatenate([p["logits"] for p in parts]), rtol=1e-5,
                               atol=1e-5)


def test_pad_to_multiple_and_run_padded():
    x = np.arange(5)[:, None, None, None].repeat(2, 1).astype(np.uint8)
    padded, n = pad_to_multiple(x, 4)
    assert n == 5 and padded.shape[0] == 8
    np.testing.assert_array_equal(padded[5:, 0, 0, 0], [0, 0, 0])
    seen = []

    def call(chunk):
        seen.append(chunk.shape[0])
        return {"v": chunk[:, 0, 0, 0].astype(np.int64) * 2}

    out = run_padded(call, x, 4)
    assert seen == [4, 4]
    np.testing.assert_array_equal(out["v"], np.arange(5) * 2)
    with pytest.raises(ValueError):
        run_padded(call, x[:0], 4)


def test_prepare_image_and_not_ported(pair):
    """prepare_image resizes; explain and amplify are ported now
    (tests/test_torch_explain.py and tests/test_torch_eval.py hold them to
    JAX's): explain gives JAX's keys and shapes."""
    _, teng = pair
    assert teng.prepare_image(images(1, size=50)[0]).shape == (IMG, IMG, 3)
    out = teng.explain(images(3))
    assert set(out) == {"logits", "expl_logits", "preds", "expl_preds", "concepts",
                        *(f"heatmap_conv{i}" for i in range(1, 6))}
    assert out["logits"].shape == out["expl_logits"].shape == (3, NC)
    assert out["preds"].shape == out["expl_preds"].shape == (3,)
    assert out["concepts"].shape == (3, NK)
    for i in range(1, 6):  # at 32², Psi's conv outputs are 1x1
        hm = out[f"heatmap_conv{i}"]
        assert hm.shape == (3, 1, 1) and hm.dtype == np.float32 and np.isfinite(hm).all()
    # amplify is ported now (tests/test_torch_eval.py holds it to JAX's).
    res = teng.amplify(images(1)[0], {"method": "top_k", "k": 1}, [1.0])
    assert len(res.amplified_images) == 1 and res.amplified_images[0].shape == (IMG, IMG, 3)


def test_bfloat16_engine_runs(pair):
    """bf16 weights cast once; logits still come out fp32 and finite."""
    jeng, teng = pair
    beng = InferenceEngine(teng.models, batch_size=4, compute_dtype="bfloat16", device="cpu")
    out = beng.classify(images(2))
    assert out["logits"].dtype == np.float32
    assert np.isfinite(out["logits"]).all()
    assert beng.reconstruct(images(1))["reconstruction_u8"].shape == (1, IMG, IMG, 3)


def test_http_round_trip(pair):
    """One server on port 0: healthz, classify (npz body), reconstruct,
    stats, and explain (no route answers 501 any more)."""
    _, teng = pair
    vs = VisCoINServer(teng, max_delay_ms=2.0)
    httpd = vs.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["device"] == "cpu"

        buf = io.BytesIO()
        np.savez(buf, images=images(2, seed=3))
        req = urllib.request.Request(base + "/v1/classify?top_k=3", data=buf.getvalue(),
                                     headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=60) as r:
            resp = json.loads(r.read())
        assert len(resp["preds"]) == 2 and len(resp["top_classes"][0]) == 3
        assert all(0 <= p < NC for p in resp["preds"])
        assert len(resp["top_concepts"][0]) == 3 and max(resp["top_concepts"][0]) < NK

        body = json.dumps({"images": images(1, seed=4).tolist()}).encode()
        req = urllib.request.Request(base + "/v1/reconstruct", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            rec = np.load(io.BytesIO(r.read()))
        assert rec["reconstruction_u8"].shape == (1, IMG, IMG, 3)
        want = teng.reconstruct(images(1, seed=4))["reconstruction_u8"]
        np.testing.assert_array_equal(rec["reconstruction_u8"], want)

        with urllib.request.urlopen(base + "/v1/stats", timeout=60) as r:
            stats = json.loads(r.read())
        assert stats["classify"]["requests"] == 2
        assert stats["reconstruct"]["requests"] == 1

        req = urllib.request.Request(base + "/v1/explain", data=buf.getvalue())
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            expl = np.load(io.BytesIO(r.read()))
        assert expl["heatmap_conv5"].shape == (2, 1, 1) and expl["preds"].shape == (2,)
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(urllib.request.Request(base + "/v1/nothing", data=b""),
                                   timeout=60)
        assert err.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        vs.close()
        thread.join(10)
