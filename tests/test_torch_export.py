"""Sealed serving artifacts of the port (``serve/export.py``; the
``export-serving`` and ``serve --from-artifact`` commands) and the kernels as
registered operators (``ops/library.py``), on the CPU.

Each operator passes ``torch.library.opcheck`` and equals its plain version
and the eager route; a gradient traced through the autograd Functions holds
the operators. The artifacts are those of a perturbed bundle given to both
packages, at the toy widths of ``tests/torch_port_helpers.py`` at 128² as in
``tests/test_torch_explain.py`` (at 32² every conv output of Psi is 1x1 and
every GradCAM heatmap the constant 0; at 128² they are 4x4), batch 2: the
port's artifact equals the port's live engine bit for bit on all three
endpoints in fp32 and bf16, and the JAX package's own artifact of the same
bundle within ``tests/test_torch_serve.py``'s and
``tests/test_torch_explain.py``'s tolerances. The fp32 artifact is written
by the ``export-serving`` command and served by ``serve --from-artifact``;
each dtype's artifact is exported once per module (a trace, a save and a
load cost seconds each), and the artifact without explain is a copy of the
fp32 one."""

import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_helpers import IMG, NC, NK, bundle_pair, images, save_jax_bundle
from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from viscoin_tpu.serve.export import export_serving as jax_export_serving
from viscoin_tpu.serve.export import load_exported as jax_load_exported
from viscoin_tpu_torch.__main__ import main
from viscoin_tpu_torch.ops import bias_act, setup_filter, upfirdn2d
from viscoin_tpu_torch.ops.bias_act import bias_act_grad_plain, bias_act_plain
from viscoin_tpu_torch.ops.upfirdn2d import upfirdn2d_plain
from viscoin_tpu_torch.serve.engine import InferenceEngine
from viscoin_tpu_torch.serve.export import ENDPOINTS, _trace, export_serving, load_exported
from viscoin_tpu_torch.serve.server import VisCoINServer

REPO = Path(__file__).resolve().parent.parent
BATCH = 2
RES, CLASSES = 128, 10  # the artifacts' geometry (test_torch_explain.py's)
HEATMAPS = [f"heatmap_conv{i}" for i in range(1, 6)]
TAPS = list(setup_filter([1.0, 3.0, 3.0, 1.0]).taps)


def _x(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


OP_CASES = {
    "bias_act lrelu clamp": ("bias_act", lambda: (_x(2, 3, 5, 6), _x(3, seed=1), "lrelu", None,
                                                  1.4, 0.5)),
    "bias_act linear no bias": ("bias_act", lambda: (_x(2, 3, 5, 6), None, "linear", None, 1.0,
                                                     None)),
    "bias_act relu features": ("bias_act", lambda: (_x(4, 3), _x(3, seed=1), "relu", 0.3, 2.0,
                                                    None)),
    "bias_act_grad db": ("bias_act_grad", lambda: (_x(2, 3, 5, 6), _x(3, seed=1),
                                                   _x(2, 3, 5, 6, seed=2), None, "lrelu", None,
                                                   1.4, 0.5, True)),
    "bias_act_grad dy_add": ("bias_act_grad", lambda: (_x(2, 3, 5, 6), _x(3, seed=1),
                                                       _x(2, 3, 5, 6, seed=2), _x(3, seed=3),
                                                       "relu", None, 1.4, None, False)),
    "bias_act_grad no bias": ("bias_act_grad", lambda: (_x(2, 3, 5, 6), None,
                                                        _x(2, 3, 5, 6, seed=2), None, "linear",
                                                        None, 1.0, None, True)),
    "upfirdn2d up": ("upfirdn2d", lambda: (_x(2, 3, 5, 6), TAPS, [2, 2], [1, 1], [2, 1, 2, 1],
                                           False, 4.0)),
    "upfirdn2d down": ("upfirdn2d", lambda: (_x(2, 3, 6, 6), TAPS, [1, 1], [2, 2], [1, 1, 1, 1],
                                             False, 1.0)),
    "upfirdn2d crop flip": ("upfirdn2d", lambda: (_x(1, 2, 7, 5), TAPS, [1, 1], [1, 1],
                                                  [-1, 2, 0, -2], True, 1.0)),
}


@pytest.mark.parametrize("case", list(OP_CASES))
def test_ops_pass_opcheck(case):
    """Schema, fake against real, and the dispatcher's autograd and
    functionalization checks, on the CPU implementation."""
    op, args = OP_CASES[case]
    result = torch.library.opcheck(getattr(torch.ops.viscoin, op).default, args())
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("case", list(OP_CASES))
def test_ops_equal_the_plain_versions_and_the_eager_route(case):
    """Each operator's CPU implementation is the plain version (bit-equal),
    and so is the eager route of the autograd Functions; the fake gives the
    real output's shape and type."""
    op, make = OP_CASES[case]
    args = make()
    got = getattr(torch.ops.viscoin, op)(*args)
    with torch._subclasses.FakeTensorMode() as mode:
        fake = getattr(torch.ops.viscoin, op)(*[mode.from_tensor(a) if isinstance(a, torch.Tensor)
                                                else a for a in args])
    if op == "bias_act":
        x, b, act, alpha, gain, clamp = args
        want = bias_act_plain(x, b, act=act, alpha=alpha, gain=gain, clamp=clamp)
        eager = bias_act(x, b, act=act, alpha=alpha, gain=gain, clamp=clamp)
        assert torch.equal(eager, want)
    elif op == "bias_act_grad":
        x, b, dy, dy_add, act, alpha, gain, clamp, need_db = args
        want = bias_act_grad_plain(x, b, dy, act=act, alpha=alpha, gain=gain, clamp=clamp,
                                   need_db=need_db, dy_add=dy_add)
        if dy_add is None:  # the first order through the Function's backward
            xg = x.clone().requires_grad_(True)
            bg = None if b is None else b.clone().requires_grad_(need_db)
            y = bias_act(xg, bg, act=act, alpha=alpha, gain=gain, clamp=clamp)
            grads = torch.autograd.grad(y, [t for t in (xg, bg) if t is not None
                                            and t.requires_grad], dy)
            assert torch.equal(grads[0], want[0])
            if b is not None and need_db:
                assert torch.equal(grads[1], want[1])
    else:
        x, taps, up, down, padding, flip, gain = args
        want = upfirdn2d_plain(x, taps, up=up, down=down, padding=padding, flip_filter=flip,
                               gain=gain)
        eager = upfirdn2d(x, setup_filter(taps, normalize=False), up=up, down=down,
                          padding=padding, flip_filter=flip, gain=gain)
        assert torch.equal(eager, want)
    for g, w, f in zip(*(o if isinstance(o, tuple) else (o,) for o in (got, want, fake))):
        assert (g is None) == (w is None) == (f is None)
        if w is not None:
            assert torch.equal(g, w) and g.is_contiguous()
            assert f.shape == w.shape and f.dtype == w.dtype


class _Tiny(torch.nn.Module):
    """conv -> bias_act (lrelu, clamp) -> 2x upsample, and the gradient of
    a loss with respect to a perturbation of the conv's output, as GradCAM
    takes one inside a serving program."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3, padding=1)
        self.bias = torch.nn.Parameter(torch.linspace(-0.5, 0.5, 4))
        self.f = setup_filter([1.0, 3.0, 3.0, 1.0])

    def forward(self, x):
        with torch.enable_grad():
            eps = torch.zeros(x.shape[0], 4, *x.shape[2:], requires_grad=True)
            h = bias_act(self.conv(x) + eps, self.bias, act="lrelu", clamp=1.0)
            y = upfirdn2d(h, self.f, up=2, padding=(2, 1, 2, 1), gain=4.0)
            grad, = torch.autograd.grad(y.square().sum(), [eps])
        return y.detach(), grad


def test_a_traced_gradient_holds_the_kernels_operators():
    """Through the autograd Functions, a traced program holds the forward
    operators and their backward (bias_act_grad, the adjoint upfirdn2d),
    and computes what the eager route computes, bit for bit."""
    m = _Tiny().eval().requires_grad_(False)
    x = _x(2, 3, 6, 6, seed=4)
    program = _trace(m, (x,))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("viscoin.bias_act.default") == 1
    assert targets.count("viscoin.bias_act_grad.default") == 1
    assert targets.count("viscoin.upfirdn2d.default") == 2  # the FIR and its adjoint
    got, want = program.module()(x), m(x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert want[1].abs().max() > 0


# ------------------------------ the artifacts ------------------------------ #


@pytest.fixture(scope="module")
def pair():
    return bundle_pair(seed=5, img=RES, n_classes=CLASSES)


@pytest.fixture(scope="module")
def live(pair):
    return {dtype: InferenceEngine(pair[1], batch_size=BATCH, compute_dtype=dtype, device="cpu")
            for dtype in ("float32", "bfloat16")}


EQUAL_IMAGES = images(3, size=RES, seed=20)  # 3 through batch 2: the second chunk padded

# The bf16 artifact in a process of its own: `export-serving` (argv[3:]),
# then the artifact loaded and run on the images of argv[1], its outputs
# saved to argv[2] as "<endpoint>/<key>".
BF16_RUN = (
    "import sys, numpy as np\n"
    "from viscoin_tpu_torch.__main__ import main\n"
    "from viscoin_tpu_torch.serve.export import load_exported\n"
    "assert main(['export-serving', *sys.argv[3:]]) == 0\n"
    "engine = load_exported(sys.argv[sys.argv.index('--output') + 1], device='cpu')\n"
    "imgs = np.load(sys.argv[1])\n"
    "np.savez(sys.argv[2], **{f'{n}/{k}': v for n in engine.endpoints\n"
    "                         for k, v in getattr(engine, n)(imgs).items()})\n"
)

# No model code at load: a fresh process loads an artifact and classifies
# through it with neither JAX nor any module of viscoin_tpu_torch.models
# imported.
FRESH_LOAD = (
    "import sys, numpy as np\n"
    "from viscoin_tpu_torch.serve.export import load_exported\n"
    "engine = load_exported(sys.argv[1], device='cpu')\n"
    f"out = engine.classify(np.zeros((3, {RES}, {RES}, 3), np.uint8))\n"
    f"assert out['logits'].shape == (3, {CLASSES}), out['logits'].shape\n"
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
    "             'viscoin_tpu') or m.startswith('viscoin_tpu_torch.models'))\n"
    "print(engine.endpoints, bad)\n"
    "sys.exit(1 if bad else 0)\n"
)


def _start(args: list[str]) -> subprocess.Popen:
    """A Python process of its own, in one thread, from the repository."""
    return subprocess.Popen([sys.executable, *args], cwd=REPO, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            env=dict(os.environ, OMP_NUM_THREADS="1"))


def _finish(proc: subprocess.Popen) -> tuple[int, str]:
    out, _ = proc.communicate(timeout=300)
    return proc.returncode, out


def _export_options(root: Path, dtype: str) -> list[str]:
    """`export-serving` of the JAX-written bundle in ``root`` (batch 2, for
    the CPU) to ``root/<dtype>``."""
    return ["--viscoin-pickle-path", str(root / "viscoin-toy"), "--device", "cpu",
            "--batch-size", str(BATCH), "--platforms", "cpu", "--compute-dtype", dtype,
            "--output", str(root / dtype)]


@pytest.fixture(scope="module", autouse=True)
def processes(pair, tmp_path_factory):
    """(the directory holding the JAX-written bundle and the artifacts, the
    processes the fixtures start, by name), the processes killed at the end
    if still running.

    Started here, before the module's first test, so that it runs beside
    all that comes before its test: the bf16 artifact's export and run
    (``BF16_RUN``), in a process of its own."""
    root = tmp_path_factory.mktemp("artifacts")
    save_jax_bundle(pair[0], str(root / "viscoin-toy"))
    np.save(root / "images.npy", EQUAL_IMAGES)
    procs = {"bfloat16": _start(["-c", BF16_RUN, str(root / "images.npy"),
                                 str(root / "bf16.npz"), *_export_options(root, "bfloat16")])}
    yield root, procs
    for proc in procs.values():
        if proc.returncode is None:  # not awaited: a test before it failed
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def served(processes):
    """`export-serving` of the JAX-written bundle in fp32, then `serve
    --from-artifact` on port 0 in a thread through ``main``: (the
    artifact's directory, its ExportedEngine, the base URL). The
    fresh-process load of that artifact (``FRESH_LOAD``) starts as soon as
    it is written."""
    root, procs = processes
    art = str(root / "float32")
    assert main(["export-serving", *_export_options(root, "float32")]) == 0
    procs["fresh load"] = _start(["-c", FRESH_LOAD, art])
    started = []
    make_server = VisCoINServer.make_server

    def spy(self, host, port):
        httpd = make_server(self, host, port)
        started.append((self, httpd))
        return httpd

    VisCoINServer.make_server = spy
    result = []
    thread = threading.Thread(target=lambda: result.append(main([
        "serve", "--from-artifact", art, "--device", "cpu", "--port", "0",
        "--max-delay-ms", "1"])), daemon=True)
    try:
        thread.start()
        deadline = time.monotonic() + 120
        while not started and thread.is_alive() and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        VisCoINServer.make_server = make_server
    assert started, "the server did not start"
    vs, httpd = started[0]
    yield art, vs.engine, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    thread.join(30)
    assert not thread.is_alive() and result == [0]
    assert all(not b._worker.is_alive() for b in vs._batchers.values())


@pytest.fixture(scope="module")
def artifact_outputs(served, processes):
    """{dtype: {endpoint: outputs}} of each dtype's artifact on
    ``EQUAL_IMAGES``: fp32 the served engine's, bf16 those of the artifact
    run in the process that exported it."""
    root, procs = processes
    rc, out = _finish(procs["bfloat16"])
    assert rc == 0, out
    bf16: dict = {}
    with np.load(root / "bf16.npz") as data:
        for name in data.files:
            endpoint, key = name.split("/")
            bf16.setdefault(endpoint, {})[key] = data[name]
    return {"float32": {e: getattr(served[1], e)(EQUAL_IMAGES) for e in ENDPOINTS},
            "bfloat16": bf16}


@pytest.fixture(scope="module")
def partial(served, tmp_path_factory):
    """An artifact of classify alone: the fp32 one without reconstruct and
    explain, as export_serving(endpoints=("classify",)) writes it."""
    art = tmp_path_factory.mktemp("partial") / "artifact"
    art.mkdir()
    for name in ("variables.npz", "classify.pt2"):
        shutil.copy(os.path.join(served[0], name), art / name)
    with open(os.path.join(served[0], "manifest.json")) as f:
        manifest = json.load(f)
    (art / "manifest.json").write_text(json.dumps(dict(manifest, endpoints=["classify"])))
    return str(art)


@pytest.fixture(scope="module")
def jax_artifact(pair, tmp_path_factory):
    """The JAX package's own artifact of the same bundle (fp32, batch 2)."""
    art = str(tmp_path_factory.mktemp("jax") / "artifact")
    jax_export_serving(pair[0], art, batch_size=BATCH)
    return art, jax_load_exported(art)


def _assert_maps_vary(out: dict):
    """Every heatmap of the reference varies within some image (a constant
    map would compare zeros)."""
    for key in HEATMAPS:
        assert out[key].shape[1:] == (4, 4), key
        assert (out[key].max(axis=(1, 2)) > out[key].min(axis=(1, 2))).any(), key


def _post(url: str, imgs: np.ndarray):
    buf = io.BytesIO()
    np.savez(buf, images=imgs)
    req = urllib.request.Request(url, data=buf.getvalue(),
                                 headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read()


def test_artifact_layout_stores_the_weights_once_in_the_jax_layout(served, jax_artifact):
    """manifest.json, variables.npz with the JAX artifact's keys and values
    (fp32), and one .pt2 per endpoint holding no weight of its own."""
    art = served[0]
    with open(os.path.join(art, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest == {"batch_size": BATCH, "resolution": RES, "compute_dtype": "float32",
                        "endpoints": list(ENDPOINTS), "torch_version": torch.__version__,
                        "platforms": ["cpu"], "traced_on": "cpu"}
    assert sorted(os.listdir(art)) == sorted(["manifest.json", "variables.npz",
                                              *(f"{e}.pt2" for e in ENDPOINTS)])
    with np.load(os.path.join(art, "variables.npz")) as got, \
            np.load(os.path.join(jax_artifact[0], "variables.npz")) as want:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for endpoint in ENDPOINTS:  # tensor data: none for weights, a few bytes of constants
        with zipfile.ZipFile(os.path.join(art, f"{endpoint}.pt2")) as z:
            data = {i.filename.split("/data/")[1]: i.file_size for i in z.infolist()
                    if "/data/" in i.filename and not i.filename.endswith(".json")}
        assert sum(n for k, n in data.items() if k.startswith("weights/")) == 0, endpoint
        assert 0 < sum(data.values()) < 1024, (endpoint, data)
    program = served[1]._fns["reconstruct"]  # bound to the engine's one copy of the weights
    weights = {t.data_ptr() for t in served[1].weights.values()}
    assert {t.data_ptr() for t in program.state_dict().values()} <= weights


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("endpoint", ENDPOINTS)
def test_artifact_equals_the_live_engine(artifact_outputs, live, dtype, endpoint):
    """Every output of the artifact's engine (the bf16 one loaded in another
    process) bit-equal to the live engine's."""
    got = artifact_outputs[dtype][endpoint]
    want = getattr(live[dtype], endpoint)(EQUAL_IMAGES)
    assert set(got) == set(want)
    if endpoint == "explain":
        _assert_maps_vary(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert np.isfinite(want[next(iter(want))].astype(np.float32)).all()


@pytest.mark.parametrize("endpoint", ENDPOINTS)
def test_artifact_matches_the_jax_artifact(served, jax_artifact, endpoint):
    """The port's fp32 artifact against the JAX package's of the same
    bundle: floats (heatmaps among them) within 1e-4, u8 within one level,
    predictions equal."""
    imgs = images(3, size=RES, seed=21)
    got = getattr(served[1], endpoint)(imgs)
    want = {k: np.asarray(v) for k, v in getattr(jax_artifact[1], endpoint)(imgs).items()}
    assert set(got) == set(want)
    if endpoint == "explain":
        _assert_maps_vary(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        if key == "reconstruction_u8":
            assert np.abs(got[key].astype(int) - want[key].astype(int)).max() <= 1
        elif key.endswith("preds"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4, err_msg=key)


def test_serve_from_artifact_answers_over_http(served, live):
    """`serve --from-artifact`: /healthz gives the manifest's batch and
    dtype; classify, reconstruct and explain answer 200 with the live
    engine's values; amplify answers 400 (it needs model code)."""
    _, engine, base = served
    with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
        health = json.loads(r.read())
    assert health["batch_size"] == BATCH and health["compute_dtype"] == "float32"
    assert health["device"] == "cpu" and health["resolution"] == RES
    imgs = images(2, size=RES, seed=22)
    status, body = _post(base + "/v1/classify", imgs)
    assert status == 200
    assert json.loads(body)["preds"] == live["float32"].classify(imgs)["logits"].argmax(-1).tolist()
    status, body = _post(base + "/v1/reconstruct", imgs)
    np.testing.assert_array_equal(np.load(io.BytesIO(body))["reconstruction_u8"],
                                  live["float32"].reconstruct(imgs)["reconstruction_u8"])
    status, body = _post(base + "/v1/explain?top_k=3", imgs)
    data, want = np.load(io.BytesIO(body)), live["float32"].explain(imgs)
    _assert_maps_vary(want)
    assert data["top_concepts"].shape == (2, 3) and data["top_concepts"].max() < NK
    for key in HEATMAPS + ["expl_preds"]:
        np.testing.assert_array_equal(data[key], want[key], err_msg=key)
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base + "/v1/amplify?top_k_concepts=1", imgs[:1])
    assert err.value.code == 400 and "amplify" in json.loads(err.value.read())["error"]


def test_partial_artifact_answers_400_for_what_it_lacks(partial):
    """An artifact without explain: the engine's KeyError names what it
    has; over HTTP /v1/explain and /v1/amplify answer 400, /v1/classify 200."""
    engine = load_exported(partial, device="cpu")
    with pytest.raises(KeyError, match="'explain' not in artifact .has \\['classify'\\]"):
        engine.explain(images(1, size=RES))
    vs = VisCoINServer(engine, max_delay_ms=1.0)
    httpd = vs.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert _post(base + "/v1/classify", images(1, size=RES, seed=23))[0] == 200
        for route in ("/v1/explain", "/v1/amplify"):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(base + route, images(1, size=RES, seed=23))
            assert err.value.code == 400, route
            assert route.split("/")[-1] in json.loads(err.value.read())["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        vs.close()
        thread.join(30)


def test_loading_needs_no_model_code_and_no_jax(served, processes):
    """A fresh process loads the fp32 artifact (all three endpoints) and
    classifies through it with neither JAX nor any module of
    viscoin_tpu_torch.models imported (``FRESH_LOAD``)."""
    rc, out = _finish(processes[1]["fresh load"])
    assert rc == 0, out
    assert f"{ENDPOINTS} []" in out, out


def test_export_and_load_refuse_what_they_cannot_serve(pair, partial, tmp_path):
    """Unknown endpoints and platforms raise before anything is written;
    loading on a device the manifest does not list, or with another torch
    release than the one that exported the artifact, raises."""
    with pytest.raises(ValueError, match="unknown endpoints"):
        export_serving(pair[1], str(tmp_path / "a"), endpoints=("amplify",))
    with pytest.raises(ValueError, match="platforms"):
        export_serving(pair[1], str(tmp_path / "a"), platforms=("tpu",))
    assert not (tmp_path / "a").exists()
    with pytest.raises(ValueError, match=r"exported for \['cpu'\], not 'cuda'"):
        load_exported(partial)  # the default device is the card
    with open(os.path.join(partial, "manifest.json")) as f:
        manifest = json.load(f)
    # Another release raises; the same release with another build tag passes
    # the check (and meets the next: here, a platform the CPU is not).
    for version, match in (("1.13.1", "exported with torch 1.13.1, this is torch"),
                           (torch.__version__.split("+")[0] + "+other",
                            r"exported for \['tpu'\], not 'cpu'")):
        other = tmp_path / version
        other.mkdir()
        (other / "manifest.json").write_text(json.dumps(dict(manifest, torch_version=version,
                                                             platforms=["tpu"])))
        with pytest.raises(ValueError, match=match):
            load_exported(str(other), device="cpu")


def test_example_runs_narrow_on_the_cpu(tmp_path):
    """`python -m viscoin_tpu_torch.example`'s forward at toy widths: the
    JAX example's shapes, finite values, two PNGs."""
    from PIL import Image

    from viscoin_tpu_torch import example

    out = example.run(n_classes=NC, n_concepts=NK, img_resolution=IMG, channel_base=256,
                      channel_max=16, device="cpu", outdir=str(tmp_path))
    assert out["classes"].shape == out["expl_classes"].shape == (2, NC)
    assert out["concept_space"].shape == (2, NK, 3, 3)
    assert out["images"].shape == (2, IMG, IMG, 3)
    assert np.isfinite(out["concept_regularization_loss"])
    for i, path in enumerate(out["paths"]):
        assert path == str(tmp_path / f"example_output_{i}.png")
        assert np.asarray(Image.open(path)).shape == (IMG, IMG, 3)
    assert example.main.__module__ == "viscoin_tpu_torch.example"
