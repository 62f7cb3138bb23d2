#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (viscoin_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                 # needs one CUDA card, about a minute
    python3 chip_smoke.py --out run.json  # also writes every number to a file

Phases, each printed as it runs; any failure raises and exits non-zero:

  1. device    nvidia-smi name and power limit, torch and CUDA versions, and
               the TF32 flags (both set off for the correctness phases);
  2. build     nvcc builds every kernel of csrc/ in parallel;
  3. kernels   each kernel against its plain torch version on the card, at
               every shape the serving path gives it (fp32 and bf16) and on
               the test configurations: ragged tiles, 70000 planes, the
               runtime-K instantiation (K = 2, 3, 5, 16), misaligned views;
               bias_act bit-equal, upfirdn2d within 1e-5 (fp32) or 2e-2
               (bf16) of the output's scale;
  4. slice     the flagship bundle (ResNet-50, 256 concepts, 200 classes,
               256² GeneratorAdapted, channel_base 16384) from a seed, served
               by InferenceEngine(device="cuda", batch_size=8): classify and
               reconstruct on 10 images in float32 and bfloat16, with the
               kernel launch counters reset before and read after each;
  5. cpu       the same weights on device="cpu" (plain versions), 2 images,
               against the card in fp32;
  6. server    the HTTP server on 127.0.0.1, port 0: concurrent classify and
               reconstruct requests, /healthz and /v1/stats;
  7. timings   per kernel (CUDA events at the path's shapes, summed over one
               device batch) beside its plain version, a one-call PyTorch
               yardstick where one exists, and its memory/compute bound; for
               the largest shapes the profiler's device time, GB/s and share
               of the bound; the per-batch device sum by the profiler; each
               wrapper's host time per call at its smallest path shape; per
               endpoint latency, img/s and peak memory, and a torch.profiler
               breakdown of reconstruct's device time;
  8. the ``{"kernels": [...]}`` line, then the device line, last.

It imports torch and viscoin_tpu_torch only.
"""

from __future__ import annotations

import argparse
import importlib
import io
import json
import math
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from viscoin_tpu_torch.models.bundle import default_models
from viscoin_tpu_torch.ops import _kernels
from viscoin_tpu_torch.ops.upfirdn2d import setup_filter
from viscoin_tpu_torch.serve.engine import InferenceEngine
from viscoin_tpu_torch.serve.server import VisCoINServer

ba = importlib.import_module("viscoin_tpu_torch.ops.bias_act")
up = importlib.import_module("viscoin_tpu_torch.ops.upfirdn2d")

# The flagship configuration (the JAX package's __graft_entry__ / bench.py).
N_CLASSES, N_CONCEPTS, RES, CHANNEL_BASE, CHANNEL_MAX, BATCH = 200, 256, 256, 16384, 512, 8
SEED = 0

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and fp32 outside the
# tensor cores, where both kernels compute.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

KERNELS = {
    "bias_act": dict(source="viscoin_tpu_torch/csrc/bias_act.cu",
                     replaces="viscoin_tpu/ops/bias_act.py:107"),
    "upfirdn2d": dict(source="viscoin_tpu_torch/csrc/upfirdn2d.cu",
                      replaces="viscoin_tpu/ops/upfirdn2d_pallas.py:39"),
}
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # relative to the output's max |value|


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def max_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    got, want = got.float(), want.float()
    assert got.shape == want.shape, (got.shape, want.shape)
    assert torch.isfinite(got).all(), "non-finite kernel output"
    return float((got - want).abs().max()), max(1.0, float(want.abs().max()))


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` with CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------- phase 1, 2 --------------------------------- #


def phase_device() -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    say("device", f"torch.cuda.get_device_name(0) = {name}; count {torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    say("device", f"TF32 defaults: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}; both set False "
        "for the correctness phases")
    return {"nvidia_smi": smi, "name": name, "count": torch.cuda.device_count(),
            "cudnn_tf32_default": torch.backends.cudnn.allow_tf32,
            "matmul_tf32_default": torch.backends.cuda.matmul.allow_tf32}


def set_tf32(on: bool) -> None:
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def phase_build() -> float:
    seconds = _kernels.build_all()
    for name in _kernels.KERNELS:
        log = _kernels.build_log.get(name, "(already built)")
        usage = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        say("build", f"{name}: " + (" | ".join(usage) or log.strip()[:200]))
    say("build", f"built {len(_kernels.KERNELS)} kernels in {seconds:.2f} s")
    return seconds


# ---------------------------- recording the path ---------------------------- #


class PathRecorder:
    """Records every kernel-wrapper call (op, shape, dtype, arguments) while
    the path runs, without changing what runs."""

    def __init__(self):
        self.calls: list[tuple] = []
        self._orig = (ba._bias_act_cuda, up._upfirdn2d_cuda)

    def __enter__(self):
        orig_ba, orig_up = self._orig

        def rec_ba(x, b, **kw):
            offset = x.data_ptr() % 16 // x.element_size()  # elements past 16-byte alignment
            self.calls.append(("bias_act", tuple(x.shape), x.dtype,
                               (None if b is None else b.dtype, offset),
                               tuple(sorted(kw.items()))))
            return orig_ba(x, b, **kw)

        def rec_up(x, f, **kw):
            taps = tuple(float(t) for t in torch.as_tensor(f).reshape(-1))
            kw = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
            self.calls.append(("upfirdn2d", tuple(x.shape), x.dtype, taps,
                               tuple(sorted(kw.items()))))
            return orig_up(x, f, **kw)

        ba._bias_act_cuda, up._upfirdn2d_cuda = rec_ba, rec_up
        return self

    def __exit__(self, *exc):
        ba._bias_act_cuda, up._upfirdn2d_cuda = self._orig

    def unique(self) -> dict[tuple, int]:
        out: dict[tuple, int] = {}
        for call in self.calls:
            out[call] = out.get(call, 0) + 1
        return out


def make_inputs(call: tuple, gen: torch.Generator):
    op, shape, dtype, extra, kw = call
    if op == "bias_act":
        b_dtype, offset = extra  # x is a view `offset` elements into its storage
        x = torch.randn(math.prod(shape) + offset, device="cuda", generator=gen).to(dtype)
        x = x[offset:].view(shape)
        b = None if b_dtype is None else \
            torch.randn(shape[1], device="cuda", generator=gen).to(b_dtype)
        return x, b, dict(kw)
    x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    return x, torch.tensor(extra), dict(kw)


def run_kernel(call, x, arg, kw):
    return (ba._bias_act_cuda if call[0] == "bias_act" else up._upfirdn2d_cuda)(x, arg, **kw)


def run_plain(call, x, arg, kw):
    if call[0] == "bias_act":
        return ba.bias_act_plain(x, arg, **kw)
    return up.upfirdn2d_plain(x, arg, **kw)


def run_library(call, x, arg, kw):
    """One PyTorch call computing the same function, or None. The port never
    calls these; they are the yardstick. bias_act has no single call."""
    if call[0] != "upfirdn2d":
        return None
    f2 = torch.outer(arg, arg).to(device=x.device, dtype=x.dtype)
    if not kw["flip_filter"]:
        f2 = f2.flip([0, 1])
    c = x.shape[1]
    (upy, upx), (dny, dnx) = up._pair(kw["up"]), up._pair(kw["down"])
    px0, px1, py0, py1 = up.parse_padding(kw["padding"])
    gain = kw["gain"]
    if (upy, upx, dny, dnx) == (1, 1, 1, 1) and px0 == px1 == py0 == py1 >= 0:
        w = (f2 * gain)[None, None].expand(c, 1, *f2.shape)
        return lambda: F.conv2d(x, w, padding=px0, groups=c)
    k = f2.shape[0]
    if (upy, upx, dny, dnx) == (2, 2, 1, 1) and f2.shape == (4, 4) and \
            (px0, px1, py0, py1) == (2, 1, 2, 1):
        # out[o] = sum_i x[i] f[2i + 2 - o]: a stride-2 transposed depthwise
        # conv with padding 1 and the filter reversed (true convolution).
        w = (f2.flip([0, 1]) * gain)[None, None].expand(c, 1, k, k)
        return lambda: F.conv_transpose2d(x, w, stride=2, padding=1, groups=c)
    return None


# --------------------------------- phase 3 ---------------------------------- #


FIR_CASES = (  # the configurations of tests/test_torch_ops.py::UPFIRDN_CASES
    dict(up=2, down=1, padding=(3, 2, 3, 2), gain=4.0),
    dict(up=2, down=1, padding=(2, 1, 2, 1), gain=4.0),
    dict(up=1, down=2, padding=(1, 1, 1, 1), gain=1.0),
    dict(up=1, down=1, padding=2, gain=1.0),
    dict(up=1, down=1, padding=(-1, 2, 0, -2), gain=1.0),
    dict(up=1, down=1, padding=1, gain=4.0))
RUNTIME_K = (  # tap counts other than 4: the runtime instantiation
    ((1.0, 1.0), dict(up=2, down=1, padding=(1, 0, 1, 0), gain=1.0)),
    ((1.0, 2.0, 1.0), dict(up=1, down=2, padding=1, gain=1.0)),
    ((1.0, 4.0, 6.0, 4.0, 1.0), dict(up=2, down=1, padding=(2, 2, 2, 2), gain=4.0)),
    (tuple(float(t) for t in range(1, 17)), dict(up=1, down=1, padding=(8, 7, 8, 7), gain=1.0)))


def fir_call(shape, dtype, taps, flip=False, **kw) -> tuple:
    taps = tuple(float(t) for t in setup_filter(list(taps)))
    return ("upfirdn2d", shape, dtype, taps, tuple(sorted(dict(kw, flip_filter=flip).items())))


def test_configurations() -> list[tuple]:
    """The configurations of tests/test_torch_ops.py and tests/test_torch_gpu.py,
    as recorded calls: the five Pallas test cases and the path's FIR on toy and
    ragged tiles (3, 5, 37, 41), asymmetric taps, odd channels, 70000 planes,
    the runtime-K instantiation (K = 2, 3, 5, 16), and bias_act with each
    activation on aligned and misaligned views."""
    calls = []
    f = (1.0, 3.0, 3.0, 1.0)
    for dtype in (torch.float32, torch.bfloat16):
        for kw in FIR_CASES:
            calls.append(fir_call((2, 8, 8, 12), dtype, f, **kw))
            calls.append(fir_call((3, 5, 37, 41), dtype, f, **kw))
        for flip in (False, True):
            calls.append(fir_call((1, 4, 10, 10), dtype, (1.0, 2.0, 4.0, 8.0), flip,
                                  up=2, down=1, padding=(3, 2, 3, 2), gain=4.0))
        calls.append(fir_call((1, 3, 6, 7), dtype, f, up=2, down=1, padding=(2, 1, 2, 1),
                              gain=4.0))
        for taps, kw in RUNTIME_K:
            calls.append(fir_call((2, 6, 23, 19), dtype, taps, **kw))
        for act in ("linear", "relu", "lrelu"):
            for extra in (dict(), dict(gain=0.5, clamp=0.3), dict(alpha=0.05, clamp=-1.0)):
                if "alpha" in extra and act != "lrelu":
                    continue
                kw = dict(act=act, alpha=extra.get("alpha"),
                          gain=extra.get("gain", ba.activation_funcs[act].def_gain),
                          clamp=extra.get("clamp"))
                if kw["clamp"] is not None and kw["clamp"] < 0:
                    kw["clamp"] = None
                kw = tuple(sorted(kw.items()))
                calls.append(("bias_act", (2, 5, 4, 3), dtype, (torch.float32, 0), kw))
                for offset in (0, 1):
                    calls.append(("bias_act", (8, 64, 32, 32), dtype, (dtype, offset), kw))
                    calls.append(("bias_act", (8, 512), dtype, (dtype, offset), kw))
    calls.append(fir_call((1, 70000, 3, 3), torch.float32, f, up=1, down=1, padding=1, gain=1.0))
    return calls


def phase_kernels(path_calls: dict[str, dict[tuple, int]]) -> dict:
    """Returns, per kernel and dtype, the largest |kernel - plain| and that
    error over max(1, max|plain|)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {(name, dt): [0.0, 0.0] for name in KERNELS for dt in TOL}
    checks = [c for calls in path_calls.values() for c in calls] + test_configurations()
    for call in checks:
        x, arg, kw = make_inputs(call, gen)
        got = run_kernel(call, x, arg, kw)
        want = run_plain(call, x, arg, kw)
        torch.cuda.synchronize()
        err, scale = max_err(got, want)
        if call[0] == "bias_act":  # the plain version's fp32 operations, rounded once
            assert err == 0.0, (call, err)
        assert err <= TOL[call[2]] * scale, (call, err, scale)
        w = worst[(call[0], call[2])]
        w[0], w[1] = max(w[0], err), max(w[1], err / scale)
        lib = run_library(call, x, arg, kw)
        if lib is not None:  # the yardstick must compute the same function
            lerr, lscale = max_err(lib(), want)
            assert lerr <= TOL[call[2]] * lscale, ("library", call, lerr, lscale)
    say("kernels", f"{len(checks)} kernel-vs-plain comparisons passed (the path's shapes in "
        "fp32 and bf16, and the test configurations; bias_act bit-equal); max |kernel - "
        "plain| (relative to "
        "max(1, max|plain|)): " + "; ".join(
            f"{name} {str(dt).removeprefix('torch.')} {a:.3e} ({r:.3e})"
            for (name, dt), (a, r) in worst.items())
        + f"; tolerance {TOL[torch.float32]:g} fp32, {TOL[torch.bfloat16]:g} bf16 (relative)")
    return {f"{name}/{str(dt).removeprefix('torch.')}": a for (name, dt), (a, r) in worst.items()}


# --------------------------------- phase 4 ---------------------------------- #


def expected_launches(models) -> dict[str, int]:
    """Kernel launches of one reconstruct device batch, counted from the
    generator's structure: an affine + a bias_act per synthesis layer and
    ToRGB, one bias_act per mapping group; one FIR per up-conv and per skip
    upsample of the running image."""
    from viscoin_tpu_torch.models.stylegan import SynthesisLayer, ToRGBLayer

    gan = models.gan
    layers = [m for m in gan.modules() if isinstance(m, SynthesisLayer)]
    torgb = [m for m in gan.modules() if isinstance(m, ToRGBLayer)]
    groups = int(bool(gan.mapping.g1)) + int(bool(gan.mapping.g2))
    ups = sum(1 for m in layers if m.up > 1)
    return {"bias_act": 2 * (len(layers) + len(torgb)) + groups,
            "upfirdn2d": ups + len(gan.synthesis.block_resolutions) - 1}


def seeded_images(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, RES, RES, 3), dtype=np.uint8)


def perturb_constants(models, seed: int) -> None:
    """Random init leaves biases, noise strengths, fixed_w_avg and BN
    statistics at 0 or 1; give them seeded values so every one of them
    moves the output."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, t in list(models.named_parameters()) + list(models.named_buffers()):
            if not t.is_floating_point():
                continue
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, device=t.device, generator=gen))
            elif name.endswith(("bias", "noise_strength", "fixed_w_avg", "running_mean")) \
                    or name.endswith("bn.weight"):
                t.add_(0.1 * torch.randn(t.shape, device=t.device, generator=gen))


def phase_slice(models) -> dict:
    per_batch = expected_launches(models)
    imgs = seeded_images(10, SEED + 1)
    n_batches = math.ceil(len(imgs) / BATCH)
    out = {"expected_per_batch": per_batch}
    for dtype in ("float32", "bfloat16"):
        engine = InferenceEngine(models, batch_size=BATCH, compute_dtype=dtype, device="cuda")
        engine.warmup()
        _kernels.reset_launch_counts()
        cls = engine.classify(imgs)
        cls_counts = _kernels.launch_counts()
        _kernels.reset_launch_counts()
        rec = engine.reconstruct(imgs)
        rec_counts = _kernels.launch_counts()
        for key, arr in cls.items():
            assert arr.shape[0] == 10 and np.isfinite(arr).all(), (dtype, key)
        np.testing.assert_allclose(cls["probas"].sum(-1), 1.0, atol=1e-3)
        assert cls["logits"].shape == (10, N_CLASSES) and cls["logits"].dtype == np.float32
        assert cls["concepts"].shape == (10, N_CONCEPTS)
        r = rec["reconstruction_u8"]
        assert r.shape == (10, RES, RES, 3) and r.dtype == np.uint8, r.shape
        assert r.std() > 0, "constant reconstruction"
        np.testing.assert_array_equal(rec["expl_preds"], cls["expl_logits"].argmax(-1))
        want = {k: v * n_batches for k, v in per_batch.items()}
        assert cls_counts == {k: 0 for k in KERNELS}, cls_counts
        assert rec_counts == want, (rec_counts, want)
        saturated = float(((r == 0) | (r == 255)).mean())
        say("slice", f"{dtype}: classify 10 images -> logits {cls['logits'].shape}, concepts "
            f"{cls['concepts'].shape}; reconstruct -> {r.shape} uint8, mean {r.mean():.2f}, "
            f"std {r.std():.2f}, saturated share {saturated:.4f}; kernel launches on "
            f"reconstruct {rec_counts} ({n_batches} device batches of {BATCH}; "
            f"{per_batch} per batch), on classify {cls_counts}")
        out[dtype] = {"reconstruct_launches": rec_counts, "classify_launches": cls_counts,
                      "saturated_share": saturated}
        if dtype == "float32":
            out["launches"] = rec_counts
        del engine
        torch.cuda.empty_cache()
    return out


# --------------------------------- phase 5 ---------------------------------- #


def phase_cpu(models) -> dict:
    """Card against CPU (plain versions), 2 images, fp32, TF32 off. Logits,
    probabilities and concepts within 1e-3 of the output's scale (two
    summation orders through 60 layers), the float reconstruction within
    1e-3 of its scale, and the u8 image within one level."""
    imgs = seeded_images(2, SEED + 2)
    cpu_models = default_models(N_CLASSES, N_CONCEPTS, RES, CHANNEL_BASE, CHANNEL_MAX,
                                device="cpu", seed=SEED)
    cpu_models.load_state_dict({k: v.cpu() for k, v in models.state_dict().items()})
    card = InferenceEngine(models, batch_size=2, device="cuda")
    cpu = InferenceEngine(cpu_models, batch_size=2, device="cpu")
    t0 = time.perf_counter()
    res = {}
    for endpoint in ("classify", "reconstruct"):
        got, want = getattr(card, endpoint)(imgs), getattr(cpu, endpoint)(imgs)
        for key in want:
            if key == "reconstruction_u8":
                diff = int(np.abs(got[key].astype(int) - want[key].astype(int)).max())
                assert diff <= 1, (key, diff)
                res[key] = diff
            elif want[key].dtype.kind == "f":
                err = float(np.abs(got[key] - want[key]).max())
                scale = max(1.0, float(np.abs(want[key]).max()))
                assert err <= 1e-3 * scale, (key, err, scale)
                res[key] = err
            else:
                np.testing.assert_array_equal(got[key], want[key])
    from viscoin_tpu_torch.data.transforms import device_preprocess

    with torch.inference_mode():
        x = device_preprocess(torch.from_numpy(imgs))
        g = card.models.forward_all(x.cuda())
        c = cpu.models.forward_all(x)
    for key in ("reconstruction", "ws", "phi", "phi_prime"):
        err = float((g[key].cpu() - c[key]).abs().max())
        scale = max(1.0, float(c[key].abs().max()))
        assert err <= 1e-3 * scale, (key, err, scale)
        res[key] = err
    say("cpu", f"card vs CPU at full width, 2 images, fp32, TF32 off: max |err| "
        + ", ".join(f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in res.items())
        + f" (tolerance 1e-3 x max(1, scale); u8 within 1 level); CPU side "
        f"{time.perf_counter() - t0:.1f} s")
    return res


# --------------------------------- phase 6 ---------------------------------- #


def phase_server(models) -> dict:
    engine = InferenceEngine(models, batch_size=BATCH, device="cuda").warmup()
    vs = VisCoINServer(engine, max_delay_ms=20.0)
    httpd = vs.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path: str, imgs: np.ndarray):
        buf = io.BytesIO()
        np.savez(buf, images=imgs)
        req = urllib.request.Request(base + path, data=buf.getvalue(),
                                     headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()

    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["device"].startswith("cuda"), health
        jobs = [("/v1/classify", seeded_images(1, 100 + i)) for i in range(5)]
        jobs += [("/v1/reconstruct", seeded_images(1, 200 + i)) for i in range(3)]
        jobs += [("/v1/classify", seeded_images(3, 300))]
        with ThreadPoolExecutor(len(jobs)) as pool:
            replies = list(pool.map(lambda j: post(*j), jobs))
        for (path, imgs), (status, body) in zip(jobs, replies):
            assert status == 200, (path, status)
            if path == "/v1/classify":
                resp = json.loads(body)
                assert len(resp["preds"]) == len(imgs)
                assert all(0 <= p < N_CLASSES for p in resp["preds"])
                want = engine.classify(imgs)
                assert resp["preds"] == want["logits"].argmax(-1).tolist()
            else:
                rec = np.load(io.BytesIO(body))
                assert rec["reconstruction_u8"].shape == (1, RES, RES, 3)
                want = engine.reconstruct(imgs)["reconstruction_u8"]
                assert int(np.abs(rec["reconstruction_u8"].astype(int) - want).max()) <= 1
        with urllib.request.urlopen(base + "/v1/stats", timeout=60) as r:
            stats = json.loads(r.read())
        assert stats["classify"]["requests"] == 8, stats
        assert stats["reconstruct"]["requests"] == 3, stats
        say("server", f"{len(jobs)} concurrent requests answered 200 and match the engine; "
            f"/v1/stats {json.dumps(stats)}")
        return stats
    finally:
        httpd.shutdown()
        httpd.server_close()
        vs.close()
        thread.join(30)


# --------------------------------- phase 7 ---------------------------------- #


def bound_ms(call: tuple) -> tuple[float, float, int]:
    """The two floors of the least time the card could take, in ms: bytes
    moved once (input, bias, output) over HBM bandwidth, and the operations
    on these inputs over the fp32 peak of the CUDA cores; and those bytes."""
    op, shape, dtype, extra, kw = call
    kw = dict(kw)
    esize = torch.tensor([], dtype=dtype).element_size()
    n_in = math.prod(shape)
    if op == "bias_act":
        has_bias = extra[0] is not None
        n_out = n_in
        nbytes = (n_in + n_out) * esize + (shape[1] * esize if has_bias else 0)
        flops = n_in * (2 + (1 if has_bias else 0) + (2 if kw["clamp"] is not None else 0))
    else:
        b, c, h, w = shape
        (upy, upx), (dny, dnx) = up._pair(kw["up"]), up._pair(kw["down"])
        px0, px1, py0, py1 = up.parse_padding(kw["padding"])
        k = len(extra)
        ho = (h * upy + py0 + py1 - k) // dny + 1
        wo = (w * upx + px0 + px1 - k) // dnx + 1
        n_out = b * c * ho * wo
        nbytes = (n_in + n_out) * esize
        # Multiply-adds on the taps that meet a real (not zero-inserted)
        # sample: about k/up rows times k/up columns, plus the row sums.
        ty, tx = math.ceil(k / upy), math.ceil(k / upx)
        flops = n_out * 2 * (ty * tx + ty)
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3, nbytes


KERNEL_SYMBOLS = {"bias_act": "bias_act_kernel", "upfirdn2d": "upfirdn2d_tiled"}
TOP_SHAPES = {"upfirdn2d": 4, "bias_act": 3}  # per-shape rows reported in full


def device_ms(fn, symbol: str | None, iters: int = 20, launches: int = 1) -> float | None:
    """Device time per call of ``fn`` by torch.profiler: the kernels whose
    name holds ``symbol`` (every kernel when None). Unlike back-to-back CUDA
    events, this does not count the host's pace between launches. The
    profiler's tracer can miss part of a window, so a session counts only if
    it recorded all ``launches`` kernels of each call (at least one per call
    when ``symbol`` is None); else it runs again, twice at most, and then
    the time is None, "not measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        mine = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                and (symbol is None or symbol in e.key)]
        if sum(e.count for e in mine) >= iters * launches:
            return sum(e.self_device_time_total for e in mine) / 1e3 / iters
    return None


def fmt_ms(t: float | None) -> str:
    return "not measured" if t is None else f"{t:.4f} ms"


def host_us(fn, calls: int = 1000) -> float:
    """Host time per call over ``calls`` back-to-back calls, then one
    synchronise: at a tiny shape this is the wrapper's own cost."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def phase_timings(models, path_calls: dict[str, dict[tuple, int]], launches: dict,
                  device: dict) -> dict:
    # Timed with PyTorch's defaults, which is what a user of the port gets.
    torch.backends.cudnn.allow_tf32 = device["cudnn_tf32_default"]
    torch.backends.cuda.matmul.allow_tf32 = device["matmul_tf32_default"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    card = device["nvidia_smi"]
    kernels = {}
    detail = {}
    for dtype_name, calls in path_calls.items():
        sums = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, lib_all=True,
                           bytes_ms=0.0, ops_ms=0.0, device_ms=0.0) for name in KERNELS}
        rows = []
        inputs = {}
        for call, mult in calls.items():
            x, arg, kw = make_inputs(call, gen)
            inputs[call] = (x, arg, kw)
            t_k = cuda_ms(lambda: run_kernel(call, x, arg, kw))
            t_p = cuda_ms(lambda: run_plain(call, x, arg, kw))
            lib = run_library(call, x, arg, kw)
            t_l = cuda_ms(lib) if lib is not None else None
            t_bytes, t_ops, nbytes = bound_ms(call)
            t_b, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
            s = sums[call[0]]
            s["ms"] += mult * t_k
            s["plain_ms"] += mult * t_p
            s["bound_ms"] += mult * t_b
            s["bytes_ms"] += mult * t_bytes
            s["ops_ms"] += mult * t_ops
            if t_l is None:
                s["lib_all"] = False
            else:
                s["library_ms"] += mult * t_l
            rows.append(dict(op=call[0], shape=list(call[1]), args=dict(call[4]), calls=mult,
                             ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=t_b, bound_by=by,
                             bytes=nbytes, gb_per_s=nbytes / t_k / 1e6, share=t_b / t_k))
        # The largest shapes of each kernel: device time by the profiler beside
        # the events, for the kernel and for the one-call yardstick.
        for name, top in TOP_SHAPES.items():
            mine = sorted((r for r in rows if r["op"] == name), key=lambda r: -r["bytes"])
            for r in mine[:top]:
                call = next(c for c in calls if c[0] == name and list(c[1]) == r["shape"]
                            and dict(c[4]) == r["args"])
                x, arg, kw = inputs[call]
                r["device_ms"] = device_ms(lambda: run_kernel(call, x, arg, kw),
                                           KERNEL_SYMBOLS[name])
                lib = run_library(call, x, arg, kw)
                r["library_device_ms"] = device_ms(lib, None) if lib is not None else None
                if r["device_ms"]:
                    r["device_gb_per_s"] = r["bytes"] / r["device_ms"] / 1e6
                    r["device_share"] = r["bound_ms"] / r["device_ms"]
                    rate = (f"{r['device_gb_per_s']:.0f} GB/s, {100 * r['device_share']:.1f}% of "
                            "the bound")
                else:
                    rate = "GB/s and share of the bound not measured"
                say("timings", f"{dtype_name} {name} {tuple(r['shape'])} x{r['calls']}: kernel "
                    f"{r['ms']:.4f} ms by events, {fmt_ms(r['device_ms'])} device (profiler); "
                    f"{rate}; bound {r['bound_ms']:.4f} ms ({r['bound_by']}); plain "
                    f"{r['plain_ms']:.4f} ms; "
                    + (f"library {fmt_ms(r['library_ms'])} by events, "
                       f"{fmt_ms(r['library_device_ms'])} device" if lib is not None
                       else "library none (no one-call equivalent)") + f"; {card}")
        # Per-batch device sum of each kernel: every path call, as often as
        # one device batch makes it, under one profiler session.
        for name in KERNELS:
            mine = [(c, m) for c, m in calls.items() if c[0] == name]
            sums[name]["device_ms"] = device_ms(
                lambda: [run_kernel(c, *inputs[c]) for c, m in mine for _ in range(m)],
                KERNEL_SYMBOLS[name], iters=5, launches=sum(m for _, m in mine))
        detail[dtype_name] = {"rows": rows, "sums": sums}
        if dtype_name == "float32":
            for name, s in sums.items():
                kernels[name] = {
                    "name": name, "route": "cuda", **KERNELS[name],
                    "launches": launches[name], "max_abs_err": None,
                    "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                    "bound_by": "bytes" if s["bytes_ms"] >= s["ops_ms"] else "operations",
                    "library_ms": s["library_ms"] if s["lib_all"] else None}
        say("timings", f"{dtype_name} per device batch of {BATCH} (sum over the path's "
            "calls): " + "; ".join(
                f"{n}: kernel {s['ms']:.4f} ms by events, {fmt_ms(s['device_ms'])} device "
                f"(profiler), plain {s['plain_ms']:.4f} ms, bound {s['bound_ms']:.4f} ms, "
                f"library {format(s['library_ms'], '.4f') if s['lib_all'] else 'none'}"
                for n, s in sums.items()) + f"; {card}")
        # The wrappers' host cost at their smallest path shape.
        host = {}
        for name in KERNELS:
            call = min((c for c in calls if c[0] == name), key=lambda c: math.prod(c[1]))
            x, arg, kw = inputs[call]
            host[name] = dict(shape=list(call[1]),
                              us=host_us(lambda: run_kernel(call, x, arg, kw)))
            say("timings", f"{dtype_name} {name} wrapper at {call[1]}: "
                f"{host[name]['us']:.2f} us of host time per call (1000 calls, one "
                f"synchronise); {card}")
        detail[f"host_{dtype_name}"] = host
        inputs.clear()  # so the endpoints' peak memory holds none of them

    endpoints = {}
    for dtype in ("float32", "bfloat16"):
        engine = InferenceEngine(models, batch_size=BATCH, compute_dtype=dtype, device="cuda")
        engine.warmup()
        imgs = seeded_images(BATCH, SEED + 4)
        for name in ("classify", "reconstruct"):
            fn = getattr(engine, name)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(10):
                t0 = time.perf_counter()
                fn(imgs)  # returns numpy: the device work has finished
                times.append((time.perf_counter() - t0) * 1e3)
            med = statistics.median(times)
            peak = torch.cuda.max_memory_allocated() / 2**20
            endpoints[f"{name}_{dtype}"] = dict(
                latency_ms_median=med, latency_ms_min=min(times), img_per_s=BATCH / med * 1e3,
                peak_mib=peak)
            say("timings", f"{name} {dtype} batch {BATCH}: median {med:.2f} ms "
                f"(min {min(times):.2f}), {BATCH / med * 1e3:.1f} img/s, peak memory "
                f"{peak:.0f} MiB")
        per_batch = {name: sum(m for c, m in path_calls[dtype].items() if c[0] == name)
                     for name in KERNELS}
        detail[f"profile_{dtype}"] = profile_reconstruct(engine, imgs, dtype, per_batch)
        del engine
        torch.cuda.empty_cache()
    return {"kernels": kernels, "endpoints": endpoints, "detail": detail}


def profile_reconstruct(engine, imgs, dtype: str, per_batch: dict[str, int]) -> dict:
    """Device time by kernel over 5 reconstruct batches (kernel events only,
    so an operator's time is not counted twice). A session counts only if it
    recorded every launch of the port's kernels (``per_batch`` each batch):
    the profiler's tracer can miss part of a window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                engine.reconstruct(imgs)
            wall = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if all(sum(e.count for e in events if KERNEL_SYMBOLS[name] in e.key) >= 5 * n
               for name, n in per_batch.items()):
            break
    else:
        say("profile", f"{dtype}: not measured (torch.profiler missed launches in three "
            "sessions)")
        return {"wall_ms": wall, "device_ms": None, "ours_ms": None, "top": []}
    total = sum(e.self_device_time_total for e in events) / 1e3
    ours = {name: sum(e.self_device_time_total for e in events if KERNEL_SYMBOLS[name] in e.key)
            / 1e3 for name in KERNELS}
    say("profile", f"{dtype}: 5 reconstruct batches: wall {wall:.1f} ms, device busy "
        f"{total:.1f} ms ({100 * total / wall:.1f}%), "
        + ", ".join(f"{n} {t:.2f} ms" for n, t in ours.items()))
    rows = []
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        rows.append(dict(name=e.key, device_ms=e.self_device_time_total / 1e3, count=e.count))
        say("profile", f"{dtype} {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5} "
            f"{e.key[:100]}")
    return {"wall_ms": wall, "device_ms": total, "ours_ms": ours, "top": rows}


# ----------------------------------- main ----------------------------------- #


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write every number to this JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    record: dict = {"device": phase_device()}
    set_tf32(False)
    record["build_s"] = phase_build()

    models = default_models(N_CLASSES, N_CONCEPTS, RES, CHANNEL_BASE, CHANNEL_MAX,
                            device="cuda", seed=SEED)
    perturb_constants(models, SEED + 10)
    n_params = sum(p.numel() for p in models.parameters())
    say("kernels", f"flagship bundle: {n_params / 1e6:.1f} M parameters from seed {SEED}")
    path_calls = {}
    for dtype in ("float32", "bfloat16"):
        engine = InferenceEngine(models, batch_size=BATCH, compute_dtype=dtype, device="cuda")
        with PathRecorder() as rec:
            engine.reconstruct(seeded_images(BATCH, SEED))
        path_calls[dtype] = rec.unique()
        del engine
    say("kernels", "path shapes per device batch: " + ", ".join(
        f"{d}: {len(c)} distinct calls, {sum(c.values())} launches"
        for d, c in path_calls.items()))
    worst = phase_kernels(path_calls)
    record["slice"] = phase_slice(models)
    record["cpu"] = phase_cpu(models)
    record["server"] = phase_server(models)
    timings = phase_timings(models, path_calls, record["slice"]["launches"], record["device"])
    record["timings"] = timings
    record["max_abs_err"] = worst
    for name, entry in timings["kernels"].items():
        entry["max_abs_err"] = worst[f"{name}/float32"]
    record["seconds"] = time.perf_counter() - t_start
    say("done", f"all phases passed in {record['seconds']:.1f} s")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(record, fh, indent=1, default=str)
    print(json.dumps({"kernels": list(timings["kernels"].values())}), flush=True)
    print(record["device"]["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": record["device"]["name"],
                                             "count": record["device"]["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
