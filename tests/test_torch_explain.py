"""The port's GradCAM over Psi (``utils/gradcam.py``), the engine's
``explain``, ``/v1/explain`` and the ``serve`` command, against the JAX
package on the same perturbed variables and seeded inputs.

The toy widths of ``tests/test_cli_analytics.py`` at 128² rather than 32²:
at 32² the classifier's last three hidden states are 4², 2² and 1², so
every conv output of Psi is 1x1 and every heatmap the constant 0; at 128²
they are 4x4."""

import io
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import NK, bundle_pair, images, jax_variables, run_once, save_jax_bundle
from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from viscoin_tpu.serve.engine import build_endpoint_fns
from viscoin_tpu.utils import gradcam as JG
from viscoin_tpu_torch.__main__ import main
from viscoin_tpu_torch.models.concept_extractor import ConceptExtractor
from viscoin_tpu_torch.serve.engine import InferenceEngine
from viscoin_tpu_torch.serve.server import VisCoINServer
from viscoin_tpu_torch.utils import gradcam as TG

IMG, NC, BATCH = 128, 10, 4
HEATMAPS = [f"heatmap_conv{i}" for i in range(1, 6)]


@pytest.fixture(scope="module")
def pair():
    return bundle_pair(seed=3, img=IMG, n_classes=NC)


@pytest.fixture(scope="module")
def engine(pair):
    return InferenceEngine(pair[1], batch_size=BATCH, device="cpu")


@pytest.fixture(scope="module")
def jax_explain(pair):
    """JAX's explain program on 6 images, compiled once (its heatmaps of a
    row do not depend on the batch)."""
    imgs = images(6, size=IMG, seed=11)
    out = run_once(build_endpoint_fns(pair[0])["explain"], jax_variables(pair[0]), imgs)
    return imgs, {k: np.asarray(v) for k, v in out.items()}


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def test_gradcam_heatmap_matches_jax():
    """Seeded activations and gradients; one image's map is all negative
    before the ReLU (a constant map, which goes to 0 in both)."""
    rng = np.random.default_rng(0)
    act = rng.standard_normal((3, 5, 6, 7)).astype(np.float32)  # NHWC, as JAX takes it
    grad = rng.standard_normal((3, 5, 6, 7)).astype(np.float32)
    act[2] = np.abs(act[2])
    grad[2] = -np.abs(grad[2])
    want = np.asarray(JG.gradcam_heatmap_device(jnp.asarray(act), jnp.asarray(grad)))
    got = TG.gradcam_heatmap(_nchw(act), _nchw(grad)).numpy()
    assert got.shape == (3, 5, 6) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.all(got[2] == 0) and got[:2].max() == 1.0


def test_concept_extractor_gradcams_matches_jax(pair):
    """Psi and Theta only, on seeded latents and labels: every map within
    1e-4 (they lie in [0, 1]) and the explainer logits within 1e-4; no
    parameter gradient is left behind."""
    jm, tm = pair
    rng = np.random.default_rng(1)
    latents = [rng.standard_normal((3, s, s, c)).astype(np.float32)
               for c, s in ((16, 16), (32, 8), (64, 4))]
    labels = np.asarray([0, 3, 7])
    want, want_logits = JG.concept_extractor_gradcams(
        jm, labels=jnp.asarray(labels), latents=tuple(jnp.asarray(a) for a in latents))
    tm.requires_grad_(True)
    got, got_logits = TG.concept_extractor_gradcams(
        tm, labels=torch.from_numpy(labels), latents=[_nchw(a) for a in latents])
    assert all(p.grad is None for p in tm.parameters())
    np.testing.assert_allclose(got_logits, want_logits, rtol=1e-4, atol=1e-4)
    assert sorted(got) == sorted(want) == [f"conv{i}" for i in range(1, 6)]
    for name in want:
        assert got[name].shape == want[name].shape == (3, 4, 4), name
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-4, err_msg=name)
        assert got[name].std() > 0, name


def test_psi_taps_leave_the_forward_unchanged(pair):
    """No perturbations: forward is what it was (forward_taps' Phi and Phi');
    tap_shapes are the conv outputs' shapes; zero perturbations change
    nothing."""
    _, tm = pair
    psi: ConceptExtractor = tm.concept_extractor
    rng = np.random.default_rng(2)
    latents = [torch.from_numpy(rng.standard_normal((2, c, s, s)).astype(np.float32))
               for c, s in ((16, 16), (32, 8), (64, 4))]
    with torch.no_grad():
        phi, y = psi(latents)
        phi_t, y_t, taps = psi.forward_taps(latents)
        zeros = [torch.zeros(s) for s in psi.tap_shapes(latents)]
        phi_z, y_z = psi(latents, zeros)
    assert [tuple(t.shape) for t in taps] == psi.tap_shapes(latents)
    for a, b in ((phi, phi_t), (y, y_t), (phi, phi_z), (y, y_z)):
        assert torch.equal(a, b)


def test_explain_matches_jax_engine(engine, jax_explain):
    """6 images through a batch-4 engine (the second chunk padded) against
    JAX's explain: JAX's keys, maps within 1e-4, predictions equal."""
    imgs, want = jax_explain
    got = engine.explain(imgs)
    assert set(got) == set(want) == {"logits", "expl_logits", "preds", "expl_preds",
                                      "concepts", *HEATMAPS}
    for key in want:
        assert got[key].shape == want[key].shape, key
        if key in ("preds", "expl_preds"):
            np.testing.assert_array_equal(got[key], want[key])
        else:
            assert got[key].dtype == np.float32, key
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4, err_msg=key)
    assert all(got[k].std() > 0 for k in HEATMAPS)


def test_explain_padding_invariance_and_chunking(engine):
    """A row's maps do not depend on its batch: 3 images in one padded batch
    == each alone; 9 images in three chunks == the chunks one at a time."""
    imgs = images(9, size=IMG, seed=12)
    batched = engine.explain(imgs[:3])
    for i in range(3):
        single = engine.explain(imgs[i])
        for key in HEATMAPS:
            np.testing.assert_allclose(batched[key][i], single[key][0], rtol=0, atol=1e-5)
        assert batched["expl_preds"][i] == single["expl_preds"][0]
    whole = engine.explain(imgs)
    parts = [engine.explain(imgs[s:s + BATCH]) for s in (0, 4, 8)]
    for key in HEATMAPS + ["expl_logits"]:
        np.testing.assert_allclose(whole[key], np.concatenate([p[key] for p in parts]),
                                   rtol=0, atol=1e-5)


def test_explain_bfloat16_engine_gives_finite_maps(pair):
    """In bf16 (JAX differentiates in the compute dtype too) the maps are
    finite fp32 in [0, 1]."""
    beng = InferenceEngine(pair[1], batch_size=BATCH, compute_dtype="bfloat16", device="cpu")
    out = beng.explain(images(2, size=IMG, seed=13))
    for key in HEATMAPS:
        assert out[key].dtype == np.float32 and out[key].shape == (2, 4, 4)
        assert np.isfinite(out[key]).all() and 0 <= out[key].min() and out[key].max() <= 1
    assert out["logits"].dtype == np.float32


@pytest.fixture
def bundle_dir(pair, tmp_path):
    return save_jax_bundle(pair[0], str(tmp_path / "viscoin-toy"))


def test_serve_command_answers_explain_over_http(bundle_dir, monkeypatch):
    """`serve --port 0` in a thread on the JAX-written bundle: every route
    answers 200, /v1/explain's npz has JAX's keys and the engine's maps;
    stopping the server ends the command normally with its batchers closed."""
    started = []
    make_server = VisCoINServer.make_server

    def spy(self, host, port):
        httpd = make_server(self, host, port)
        started.append((self, httpd))
        return httpd

    monkeypatch.setattr(VisCoINServer, "make_server", spy)
    result = []
    thread = threading.Thread(target=lambda: result.append(main([
        "serve", "--viscoin-pickle-path", bundle_dir, "--device", "cpu", "--port", "0",
        "--compute-dtype", "float32", "--batch-size", str(BATCH), "--max-delay-ms", "1"])),
        daemon=True)
    thread.start()
    deadline = time.monotonic() + 60
    while not started and thread.is_alive() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert started, "the server did not start"
    vs, httpd = started[0]
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    imgs = images(2, size=IMG, seed=14)
    buf = io.BytesIO()
    np.savez(buf, images=imgs)

    def post(route: str, body: bytes | None = None):
        req = urllib.request.Request(base + route, data=body or buf.getvalue(),
                                     headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()

    try:
        one = io.BytesIO()
        np.savez(one, images=imgs[:1])
        assert post("/v1/amplify?top_k_concepts=1", one.getvalue())[0] == 200
        for route in ("/v1/classify", "/v1/reconstruct", "/v1/explain?top_k=3"):
            status, body = post(route)
            assert status == 200, route
        data = np.load(io.BytesIO(body))
        assert set(data.files) == {"preds", "expl_preds", "top_concepts",
                                   "top_concept_activations", *HEATMAPS}
        assert data["top_concepts"].shape == (2, 3) and data["top_concepts"].max() < NK
        want = vs.engine.explain(imgs)
        for key in HEATMAPS:
            np.testing.assert_allclose(data[key], want[key], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(data["expl_preds"], want["expl_preds"])
        np.testing.assert_allclose(
            data["top_concept_activations"], np.sort(want["concepts"], axis=-1)[:, ::-1][:, :3],
            rtol=1e-6)
    finally:
        httpd.shutdown()
        thread.join(30)
    assert not thread.is_alive() and result == [0]
    assert all(not b._worker.is_alive() for b in vs._batchers.values())


@pytest.mark.parametrize("argv, error, match", [
    (["serve", "--from-artifact", "art", "--batch-size", "8"], ValueError,
     "--batch-size cannot be combined with --from-artifact"),
    (["export-serving", "--output", "art", "--viscoin-pickle-path", "no-such-bundle"],
     FileNotFoundError, "no-such-bundle"),
    (["serve", "--data-parallel", "--batch-size", "3"], ValueError, "3 does not divide over "
                                                                    "the 2 visible cards"),
], ids=["from-artifact", "export-serving", "data-parallel"])
def test_unported_serving_options_raise(argv, error, match, monkeypatch, tmp_path):
    """What cannot be served raises before anything is read or built: a
    flag the artifact's manifest fixed beside --from-artifact, an
    export-serving of a bundle that does not exist, and serving over two
    cards at a batch that does not divide over them. (Sealed artifacts and
    data parallelism are ported: tests/test_torch_export.py serves an
    artifact; serve/engine.py keeps the replicas.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(error, match=match):
        main(argv)
    assert not (tmp_path / "art").exists()


@pytest.mark.parametrize("flags", [
    ["--batch-size", "8"], ["--compute-dtype", "float32"], ["--data-parallel"],
    ["--no-data-parallel", "--batch-size", "2"],
], ids=["batch-size", "compute-dtype", "data-parallel", "two"])
def test_from_artifact_refuses_the_sealed_flags(flags, tmp_path):
    """`serve --from-artifact` refuses an explicitly passed --batch-size,
    --compute-dtype or --data-parallel (the artifact's manifest fixed them),
    naming each, before it reads the artifact; their defaults pass."""
    with pytest.raises(ValueError, match="cannot be combined with --from-artifact") as err:
        main(["serve", "--from-artifact", str(tmp_path / "none"), "--device", "cpu", *flags])
    named = [f for f in flags if f.startswith("--")]
    assert all(f.replace("--no-", "--") in str(err.value) for f in named)
    with pytest.raises(FileNotFoundError):
        main(["serve", "--from-artifact", str(tmp_path / "none"), "--device", "cpu"])


def test_data_parallel_on_one_card_serves_on_it(bundle_dir, monkeypatch):
    """`--data-parallel` with one visible device serves on it (the JAX
    command's one-device case); on the CPU, likewise."""
    from viscoin_tpu_torch.serve import server

    seen = []
    monkeypatch.setattr(server, "run_server", lambda engine, **kw: seen.append((engine, kw)))
    assert main(["serve", "--viscoin-pickle-path", bundle_dir, "--device", "cpu",
                 "--data-parallel", "--port", "0", "--batch-size", "2"]) == 0
    (engine, kw), = seen
    assert engine.device.type == "cpu" and engine.batch_size == 2
    assert engine.compute_dtype == "bfloat16" and kw["port"] == 0
    assert kw["host"] == "127.0.0.1" and kw["max_delay_ms"] == 5.0
