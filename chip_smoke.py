#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (viscoin_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                 # needs one CUDA card, a few minutes
    python3 chip_smoke.py --out run.json  # also writes every number to a file

Phases, each printed as it runs; any failure raises and exits non-zero:

  1. device    nvidia-smi name and power limit, torch and CUDA versions, and
               the TF32 flags (both set off for the correctness phases);
  2. build     nvcc builds every kernel source of csrc/ in parallel (three
               kernels: bias_act, its backward bias_act_grad, upfirdn2d);
  3. kernels   each kernel against its plain torch version on the card, at
               every shape the serving path and the training step give it
               (fp32 and bf16; the step's backward kernels and adjoint FIRs
               included) and on the test configurations: ragged tiles, 70000
               planes, the runtime-K instantiation (K = 2, 3, 5, 16),
               misaligned views; bias_act and bias_act_grad's dx bit-equal,
               db within 1e-5, upfirdn2d within 1e-5 (fp32) or 2e-2 (bf16)
               of the output's scale; then <y, A x> = <A^T y, x> for every
               FIR of the training step, A^T by autograd (the adjoint kernel);
  4. slice     the flagship bundle (ResNet-50, 256 concepts, 200 classes,
               256² GeneratorAdapted, channel_base 16384) from a seed, served
               by InferenceEngine(device="cuda", batch_size=8): classify and
               reconstruct on 10 images in float32 and bfloat16, with the
               kernel launch counters reset before and read after each;
  5. cpu       the same weights on device="cpu" (plain versions), 2 images,
               against the card in fp32;
  6. server    the HTTP server on 127.0.0.1, port 0: concurrent classify and
               reconstruct requests, /healthz and /v1/stats;
  7. train     the VisCoIN training step at flagship width (the bundle, a
               frozen original Generator with 2 mapping layers, LPIPS-VGG;
               batch 8 real + 8 synthetic, sampled 2 steps at a time), in
               float32 and bfloat16: exact launch counts of one step and one
               sampler call, finite losses, a non-zero gradient on every
               trainable leaf, 3 + 10 steps on the host clock, peak memory,
               one step under torch.profiler;
  8. train-cpu one fp32 step's gradients at full width on 1 real + 1
               synthetic image, card against device="cpu";
  9. timings   per kernel (CUDA events at the path's shapes, summed over one
               reconstruct batch or one train step) beside its plain version,
               a one-call PyTorch yardstick where one exists, and its
               memory/compute bound; for the largest shapes the profiler's
               device time, GB/s and share of the bound; the per-path device
               sum by the profiler; each wrapper's host time per call at its
               smallest path shape; per endpoint latency, img/s and peak
               memory, and a torch.profiler breakdown of reconstruct;
 10. the ``{"kernels": [...]}`` line, then the device line, last.

It imports torch and viscoin_tpu_torch only.
"""

from __future__ import annotations

import argparse
import copy
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

from viscoin_tpu_torch.data.transforms import device_preprocess
from viscoin_tpu_torch.models.bundle import default_models, init_models
from viscoin_tpu_torch.models.lpips import LPIPS
from viscoin_tpu_torch.models.stylegan import Generator
from viscoin_tpu_torch.ops import _kernels
from viscoin_tpu_torch.ops.upfirdn2d import setup_filter
from viscoin_tpu_torch.serve.engine import InferenceEngine
from viscoin_tpu_torch.serve.server import VisCoINServer
from viscoin_tpu_torch.train import viscoin as T

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
    # The backward of the same op: in JAX, jax.grad derives it from the XLA
    # path (viscoin_tpu/ops/bias_act.py:87-99) of that kernel's function.
    "bias_act_grad": dict(source="viscoin_tpu_torch/csrc/bias_act.cu",
                          replaces="viscoin_tpu/ops/bias_act.py:107"),
    "upfirdn2d": dict(source="viscoin_tpu_torch/csrc/upfirdn2d.cu",
                      replaces="viscoin_tpu/ops/upfirdn2d_pallas.py:39"),
}
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # relative to the output's max |value|
# bias_act_grad's db: fp32 atomics sum in another order than the plain
# version; relative to its scale, plus one rounding to the bias's type.
DB_TOL = 1e-5


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


def tf32_defaults(device: dict) -> None:
    """PyTorch's TF32 defaults, which a user of the port gets: the timed
    phases run with them."""
    torch.backends.cudnn.allow_tf32 = device["cudnn_tf32_default"]
    torch.backends.cuda.matmul.allow_tf32 = device["matmul_tf32_default"]


def phase_build() -> float:
    seconds = _kernels.build_all()
    for name in _kernels.SOURCES:
        log = _kernels.build_log.get(name, "(already built)")
        usage = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        say("build", f"{name}.cu: " + (" | ".join(usage) or log.strip()[:200]))
    say("build", f"built {len(_kernels.KERNELS)} kernels ({', '.join(_kernels.KERNELS)}) from "
        f"{len(_kernels.SOURCES)} sources in {seconds:.2f} s")
    return seconds


# ---------------------------- recording the path ---------------------------- #


class PathRecorder:
    """Records every kernel-wrapper call (op, shape, dtype, arguments) while
    the path runs, without changing what runs."""

    def __init__(self):
        self.calls: list[tuple] = []
        self._orig = (ba._bias_act_cuda, ba._bias_act_grad_cuda, up._upfirdn2d_cuda)

    def __enter__(self):
        orig_ba, orig_grad, orig_up = self._orig

        def rec_ba(x, b, **kw):
            offset = x.data_ptr() % 16 // x.element_size()  # elements past 16-byte alignment
            self.calls.append(("bias_act", tuple(x.shape), x.dtype,
                               (None if b is None else b.dtype, offset),
                               tuple(sorted(kw.items()))))
            return orig_ba(x, b, **kw)

        def rec_grad(x, b, dy, *, need_db=True, **kw):
            offset = x.data_ptr() % 16 // x.element_size()
            self.calls.append(("bias_act_grad", tuple(x.shape), x.dtype,
                               (None if b is None else b.dtype, offset, need_db),
                               tuple(sorted(kw.items()))))
            return orig_grad(x, b, dy, need_db=need_db, **kw)

        def rec_up(x, f, **kw):
            taps = tuple(float(t) for t in torch.as_tensor(f).reshape(-1))
            kw = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
            self.calls.append(("upfirdn2d", tuple(x.shape), x.dtype, taps,
                               tuple(sorted(kw.items()))))
            return orig_up(x, f, **kw)

        ba._bias_act_cuda, ba._bias_act_grad_cuda, up._upfirdn2d_cuda = rec_ba, rec_grad, rec_up
        return self

    def __exit__(self, *exc):
        ba._bias_act_cuda, ba._bias_act_grad_cuda, up._upfirdn2d_cuda = self._orig

    def unique(self) -> dict[tuple, int]:
        out: dict[tuple, int] = {}
        for call in self.calls:
            out[call] = out.get(call, 0) + 1
        return out


def make_inputs(call: tuple, gen: torch.Generator):
    """(x, arg, kw) for a recorded call: arg is the bias (bias_act), (bias,
    dy, need_db) (bias_act_grad) or the taps (upfirdn2d). bias_act inputs
    lie on a 1/8 grid, so that the backward meets its ties (t = 0, y0 at
    the clamp)."""
    op, shape, dtype, extra, kw = call
    if op in ("bias_act", "bias_act_grad"):
        b_dtype, offset = extra[:2]  # x is a view `offset` elements into its storage
        x = (torch.randint(-24, 25, (math.prod(shape) + offset,), device="cuda", generator=gen)
             / 8).to(dtype)
        x = x[offset:].view(shape)
        b = None if b_dtype is None else \
            (torch.randint(-8, 9, (shape[1],), device="cuda", generator=gen) / 8).to(b_dtype)
        if op == "bias_act":
            return x, b, dict(kw)
        dy = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        return x, (b, dy, extra[2]), dict(kw)
    x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    return x, torch.tensor(extra), dict(kw)


def run_kernel(call, x, arg, kw):
    if call[0] == "bias_act_grad":
        b, dy, need_db = arg
        return ba._bias_act_grad_cuda(x, b, dy, need_db=need_db, **kw)
    return (ba._bias_act_cuda if call[0] == "bias_act" else up._upfirdn2d_cuda)(x, arg, **kw)


def run_plain(call, x, arg, kw):
    if call[0] == "bias_act_grad":
        b, dy, need_db = arg
        return ba.bias_act_grad_plain(x, b, dy, need_db=need_db, **kw)
    if call[0] == "bias_act":
        return ba.bias_act_plain(x, arg, **kw)
    return up.upfirdn2d_plain(x, arg, **kw)


def run_library(call, x, arg, kw):
    """One PyTorch call computing the same function, or None. The port never
    calls these; they are the yardstick. bias_act and its backward have no
    single call."""
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
        if call[0] == "bias_act_grad":  # (dx, db): db sums by fp32 atomics, in any order
            (got, db), (want, want_db) = got, want
            assert (db is None) == (want_db is None), call
            if db is not None:  # plus one rounding to the bias's type
                assert db.dtype == want_db.dtype, call
                db_err, db_scale = max_err(db, want_db)
                slack = DB_TOL * db_scale + torch.finfo(db.dtype).eps * want_db.float().abs()
                assert bool(((db.float() - want_db.float()).abs() <= slack).all()), \
                    (call, db_err, db_scale)
        err, scale = max_err(got, want)
        if call[0] != "upfirdn2d":  # the plain version's fp32 operations, rounded once
            assert err == 0.0, (call, err)
        assert err <= TOL[call[2]] * scale, (call, err, scale)
        w = worst[(call[0], call[2])]
        w[0], w[1] = max(w[0], err), max(w[1], err / scale)
        lib = run_library(call, x, arg, kw)
        if lib is not None:  # the yardstick must compute the same function
            lerr, lscale = max_err(lib(), want)
            assert lerr <= TOL[call[2]] * lscale, ("library", call, lerr, lscale)
    say("kernels", f"{len(checks)} kernel-vs-plain comparisons passed (the serving and "
        "training paths' shapes in fp32 and bf16, and the test configurations; bias_act and "
        f"bias_act_grad's dx bit-equal, db within {DB_TOL:g} of its scale and one rounding); "
        "max |kernel - "
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
    return {"bias_act": 2 * (len(layers) + len(torgb)) + groups, "bias_act_grad": 0,
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


# ------------------------------ training phases ----------------------------- #

TRAIN_WARMUP, TRAIN_STEPS = 3, 10
GRAD_TOL = 1e-2  # card vs CPU: |grad difference| / the leaf's max |grad|


def expected_train_launches(models, mapping_layers: int) -> tuple[dict, dict]:
    """Launches of one train step and of one sampler call. The step runs
    the adapted generator once (every bias_act, every FIR) and its backward:
    one bias_act_grad per bias_act (every input needs a gradient, through
    the styles) and one adjoint FIR per FIR. The sampler runs the original
    generator: the synthesis and its mapping's FCs, no backward."""
    e = expected_launches(models)
    step = {"bias_act": e["bias_act"], "bias_act_grad": e["bias_act"],
            "upfirdn2d": 2 * e["upfirdn2d"]}
    groups = int(bool(models.gan.mapping.g1)) + int(bool(models.gan.mapping.g2))
    sampler = {"bias_act": e["bias_act"] - groups + mapping_layers, "bias_act_grad": 0,
               "upfirdn2d": e["upfirdn2d"]}
    return step, sampler


def train_modules():
    """The frozen original generator (flagship: z 512, w 512, 2 mapping
    layers, channel_base 16384) and LPIPS-VGG, from seeds."""
    gen = init_models(Generator(z_dim=512, w_dim=512, img_resolution=RES, mapping_layers=2,
                                channel_base=CHANNEL_BASE, channel_max=CHANNEL_MAX,
                                device="cuda"), SEED + 20)
    perturb_constants(gen, SEED + 21)
    lpips = init_models(LPIPS(device="cuda"), SEED + 22)
    return gen, lpips


class TrainRun:
    """One compute dtype's training on the card: a copy of the bundle (the
    step updates it in place), the state, the step and the K-step sampler,
    and four seeded u8 batches with labels, cycled."""

    def __init__(self, models, gen, lpips, dtype: str):
        self.models = copy.deepcopy(models)
        self.cfg = T.VisCoINTrainingParams(batch_size=BATCH, compute_dtype=dtype)
        self.frozen = T.make_frozen(self.models, gen, lpips, dtype)
        self.state = T.create_train_state(self.models, self.cfg)
        # Start past the warm-up gate (cd_fid_iteration), as a resumed run
        # would: all six loss terms, and so every trainable leaf, are live.
        self.state.step = self.cfg.cd_fid_iteration + 1
        self.step_fn = T.make_train_step(self.models, gen, lpips, self.cfg, external_fakes=True)
        self.sample = T.make_sample_fakes(gen, self.cfg)
        self.k = self.cfg.fake_presample_steps
        self.group, self.fakes = None, None
        self.images = torch.from_numpy(seeded_images(4 * BATCH, SEED + 40)).cuda()
        self.labels = torch.from_numpy(
            np.random.default_rng(SEED + 41).integers(0, N_CLASSES, 4 * BATCH)).cuda()

    def sample_if_needed(self) -> bool:
        """Draw the K-step group of synthetic batches the next step is in
        (groups aligned to absolute steps, as the JAX loop does)."""
        group = (self.state.step // self.k) * self.k
        if group == self.group:
            return False
        self.fakes = self.sample(self.frozen, T.fake_sample_keys(SEED, group, self.k))
        self.group = group
        return True

    def step(self) -> dict:
        i = self.state.step
        j = i % 4
        rows = slice(j * BATCH, (j + 1) * BATCH)
        _, metrics = self.step_fn(self.state, self.frozen, self.images[rows], self.labels[rows],
                                  T.step_generator(SEED, i, self.images.device), self.fakes[i - self.group])
        return metrics

    def record(self) -> dict[tuple, int]:
        """One step (sampling first) under the recorder: the step's kernel
        calls, forward and backward."""
        self.sample_if_needed()
        with PathRecorder() as rec:
            self.step()
        torch.cuda.synchronize()
        return rec.unique()


def phase_adjoint(calls: dict[tuple, int]) -> float:
    """<y, A x> = <A^T y, x> on the card for every FIR of the fp32 train
    step (the forward geometries and their adjoints), A^T through autograd,
    which launches the kernel with the adjoint geometry. Returns the largest
    |<y, A x> - <A^T y, x>| / (|y| |A x|)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    worst, n = 0.0, 0
    for call in calls:
        if call[0] != "upfirdn2d":
            continue
        x, taps, kw = make_inputs(call, gen)
        x.requires_grad_(True)
        y = up.upfirdn2d(x, taps, **kw)
        assert y.grad_fn is not None
        dy = torch.randn(y.shape, device="cuda", generator=gen)
        y.backward(dy)
        lhs = float((y.detach().double() * dy.double()).sum())
        rhs = float((x.detach().double() * x.grad.double()).sum())
        scale = float(y.detach().double().norm() * dy.double().norm())
        rel = abs(lhs - rhs) / scale
        assert rel <= 1e-6, (call, lhs, rhs, scale)
        worst, n = max(worst, rel), n + 1
    say("adjoint", f"<y, A x> = <A^T y, x> on the card for the train step's {n} FIR "
        f"geometries (forward and adjoint), fp32: largest |difference| / (|y| |A x|) "
        f"{worst:.3e} (tolerance 1e-6)")
    return worst


def phase_train(runs: dict[str, TrainRun], models, card: str) -> tuple[dict, dict]:
    """For each dtype: exact launch counts of one step and one sampler call,
    the grad_fn of each wrapper's CUDA output, finite losses and a non-zero
    gradient on every trainable leaf; then TRAIN_WARMUP + TRAIN_STEPS steps
    timed on the host clock (each step ends by reading its loss), peak
    memory, and one step under torch.profiler. Returns (record, the fp32
    step's launch counts)."""
    step_want, sampler_want = expected_train_launches(models, 2)
    x = torch.randn(2, 4, 8, 8, device="cuda", requires_grad=True)
    for name, out in (("bias_act", ba.bias_act(x, torch.zeros(4, device="cuda"), act="lrelu")),
                      ("upfirdn2d", up.upfirdn2d(x, setup_filter([1, 3, 3, 1]), padding=1))):
        assert out.is_cuda and out.grad_fn is not None, name
    record = {"expected_step_launches": step_want, "expected_sampler_launches": sampler_want}
    launches = None
    for dtype, run in runs.items():
        run.group = None  # the next step samples, so the sampler is counted once
        _kernels.reset_launch_counts()
        assert run.sample_if_needed()
        sampler_counts = _kernels.launch_counts()
        _kernels.reset_launch_counts()
        metrics = run.step()
        step_counts = _kernels.launch_counts()
        assert step_counts == step_want, (dtype, step_counts, step_want)
        assert sampler_counts == sampler_want, (dtype, sampler_counts, sampler_want)
        values = {k: float(v) for k, v in metrics.items()}
        assert all(math.isfinite(v) for v in values.values()), values
        zero = [f"{g}.{n}" for g, grp in run.state.params.items() for n, p in grp.items()
                if p.grad is None or not float(p.grad.abs().max()) > 0
                or not torch.isfinite(p.grad).all()]
        assert not zero, (dtype, zero)
        n_leaves = sum(len(grp) for grp in run.state.params.values())
        say("train", f"{dtype}: one step launched {step_counts} (expected {step_want}); the "
            f"sampler ({run.k} x {BATCH} images) launched {sampler_counts}; losses "
            + ", ".join(f"{k} {v:.4f}" for k, v in values.items())
            + f"; all {n_leaves} trainable leaves of Psi, Theta and the mapping have finite, "
            "non-zero gradients")
        if dtype == "float32":
            launches = step_counts

        step_ms, sample_ms = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for it in range(TRAIN_WARMUP + TRAIN_STEPS):
            t0 = time.perf_counter()
            sampled = run.sample_if_needed()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss = float(run.step()["total_loss"])  # reading the loss ends the step
            t2 = time.perf_counter()
            assert math.isfinite(loss)
            if it >= TRAIN_WARMUP:
                step_ms.append((t2 - t1) * 1e3)
                if sampled:
                    sample_ms.append((t1 - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**20
        per_step = statistics.mean(step_ms) + statistics.mean(sample_ms) / run.k
        rec = dict(launches=step_counts, sampler_launches=sampler_counts, losses=values,
                   step_ms_median=statistics.median(step_ms), step_ms_mean=statistics.mean(step_ms),
                   step_ms_min=min(step_ms), sampler_ms_median=statistics.median(sample_ms),
                   ms_per_step_with_sampling=per_step, img_per_s=BATCH / per_step * 1e3,
                   peak_mib=peak, step_ms=step_ms, sampler_ms=sample_ms)
        say("train", f"{dtype} batch {BATCH} (+{BATCH} synthetic): step median "
            f"{rec['step_ms_median']:.2f} ms (mean {rec['step_ms_mean']:.2f}, min "
            f"{rec['step_ms_min']:.2f}; {TRAIN_STEPS} steps after {TRAIN_WARMUP}); sampler "
            f"median {rec['sampler_ms_median']:.2f} ms per {run.k}-step group; "
            f"{per_step:.2f} ms per step with its share of sampling = "
            f"{rec['img_per_s']:.1f} real img/s; peak memory {peak:.0f} MiB; TF32 "
            f"cudnn={torch.backends.cudnn.allow_tf32}, matmul="
            f"{torch.backends.cuda.matmul.allow_tf32} (PyTorch's defaults); {card}")
        rec["profile"] = profile_step(run, dtype, step_want)
        record[dtype] = rec
    return record, launches


def profile_step(run: TrainRun, dtype: str, want: dict[str, int]) -> dict:
    """Device time by kernel and by class of kernel over one train step (the
    sampler runs before the window); a session counts only if it recorded
    every launch of the port's kernels."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        run.sample_if_needed()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            float(run.step()["total_loss"])
            wall = (time.perf_counter() - t0) * 1e3
        events = kernel_events(prof)
        if all(sum(e.count for e in events if KERNEL_SYMBOLS[name] in e.key) >= n
               for name, n in want.items()):
            break
    else:
        say("profile", f"train {dtype}: not measured (torch.profiler missed launches in three "
            "sessions)")
        return {"wall_ms": wall, "device_ms": None, "ours_ms": None, "top": []}
    total = sum(e.self_device_time_total for e in events) / 1e3
    ours = {name: sum(e.self_device_time_total for e in events if KERNEL_SYMBOLS[name] in e.key)
            / 1e3 for name in KERNELS}
    say("profile", f"train {dtype}: one step: wall {wall:.1f} ms, device busy {total:.1f} ms "
        f"({100 * total / wall:.1f}%), " + ", ".join(f"{n} {t:.3f} ms" for n, t in ours.items()))
    rows = []
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        rows.append(dict(name=e.key, device_ms=e.self_device_time_total / 1e3, count=e.count))
        say("profile", f"train {dtype} {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5} "
            f"{e.key[:100]}")
    classes: dict[str, list] = {}
    for e in events:
        c = classes.setdefault(classify_kernel(e.key), [0.0, 0])
        c[0] += e.self_device_time_total / 1e3
        c[1] += e.count
    say("profile", f"train {dtype} by class of kernel: " + "; ".join(
        f"{cls} {ms:.2f} ms ({100 * ms / total:.1f}%, {n} launches)"
        for cls, (ms, n) in sorted(classes.items(), key=lambda kv: -kv[1][0])))
    return {"wall_ms": wall, "device_ms": total, "ours_ms": ours, "top": rows,
            "classes": classes, "launches": sum(e.count for e in events)}


def phase_train_cpu(models, lpips) -> dict:
    """One fp32 loss and its gradients at full width on 1 real + 1 synthetic
    image, on the card (kernels) and on device="cpu" (plain versions), from
    the same weights, inputs and dropout mask, with the noise strengths at
    zero and TF32 off: totals within 1e-4, every trainable gradient within
    GRAD_TOL of its leaf's max |grad|."""
    set_tf32(False)
    card_models = copy.deepcopy(models)
    with torch.no_grad():
        for name, p in card_models.named_parameters():
            if name.endswith("noise_strength"):
                p.zero_()
    cpu_models = default_models(N_CLASSES, N_CONCEPTS, RES, CHANNEL_BASE, CHANNEL_MAX,
                                device="cpu", seed=SEED)
    cpu_models.load_state_dict({k: v.cpu() for k, v in card_models.state_dict().items()})
    cpu_lpips = LPIPS(device="cpu")
    cpu_lpips.load_state_dict({k: v.cpu() for k, v in lpips.state_dict().items()})
    rng = np.random.default_rng(SEED + 50)
    real = device_preprocess(torch.from_numpy(seeded_images(1, SEED + 51)))
    fake = torch.from_numpy((0.5 * rng.standard_normal((1, 3, RES, RES))).astype(np.float32))
    labels = torch.tensor([3])
    mask = torch.from_numpy(rng.random((2, N_CONCEPTS, 3, 3)) < 0.99)
    cfg = T.VisCoINTrainingParams(batch_size=1, cd_fid_iteration=-1)
    out = {}
    t0 = time.perf_counter()
    for device, m, lp in (("cuda", card_models, lpips), ("cpu", cpu_models, cpu_lpips)):
        frozen = T.make_frozen(m, None, lp)
        state = T.create_train_state(m, cfg)
        loss_fn = T.make_loss_fn(m, None, lp, cfg)
        _kernels.reset_launch_counts()
        total, _ = loss_fn(state.params, frozen, real.to(device), labels.to(device), 0,
                           torch.Generator(device=device).manual_seed(0), fake.to(device),
                           dropout_mask=mask.to(device))
        leaves = [(f"{g}.{n}", p) for g, grp in state.params.items() for n, p in grp.items()]
        grads = torch.autograd.grad(total, [p for _, p in leaves])
        out[device] = (float(total.detach()), {k: g.cpu() for (k, _), g in zip(leaves, grads)},
                       _kernels.launch_counts())
    (t_card, g_card, c_card), (t_cpu, g_cpu, c_cpu) = out["cuda"], out["cpu"]
    assert set(c_cpu.values()) == {0} and min(c_card.values()) > 0, (c_card, c_cpu)
    total_err = abs(t_card - t_cpu) / abs(t_cpu)
    assert total_err <= 1e-4, (t_card, t_cpu)
    ratios = {}
    for key, want in g_cpu.items():
        scale = float(want.abs().max())
        assert scale > 0 and float(g_card[key].abs().max()) > 0, key
        ratios[key] = float((g_card[key] - want).abs().max()) / scale
    worst = max(ratios, key=ratios.get)
    assert ratios[worst] <= GRAD_TOL, (worst, ratios[worst])
    say("train-cpu", f"one fp32 step at full width, 1 real + 1 synthetic image, TF32 off, noise "
        f"strengths 0, dropout mask fixed: total card {t_card:.6f}, CPU {t_cpu:.6f} (rel. "
        f"{total_err:.2e}); {len(ratios)} trainable gradients, max |card - CPU| / leaf max "
        f"|grad|: worst {worst} {ratios[worst]:.3e}, median "
        f"{statistics.median(ratios.values()):.3e} (tolerance {GRAD_TOL:g}); launches on the "
        f"card {c_card}; {time.perf_counter() - t0:.1f} s")
    return {"total_card": t_card, "total_cpu": t_cpu, "total_rel_err": total_err,
            "grad_rel_err": ratios, "card_launches": c_card}


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
    elif op == "bias_act_grad":
        # Reads x and dy, writes dx; reads the bias and writes db (fp32)
        # where there is one. Per element: the bias add, gain and act'
        # products, with a clamp the recomputed output and its factor, and
        # the db sum.
        has_bias, need_db = extra[0] is not None, extra[0] is not None and extra[2]
        nbytes = 3 * n_in * esize + (shape[1] * esize if has_bias else 0) \
            + (shape[1] * 4 if need_db else 0)
        flops = n_in * (2 + has_bias + (3 if kw["clamp"] is not None else 0) + need_db)
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


KERNEL_SYMBOLS = {"bias_act": "bias_act_kernel", "bias_act_grad": "bias_act_grad_kernel",
                  "upfirdn2d": "upfirdn2d_tiled"}
TOP_SHAPES = {"upfirdn2d": 4, "bias_act": 3, "bias_act_grad": 3}  # per-shape rows in full


def kernel_events(prof) -> list:
    """The device kernels of a profiler session, by name: CUDA events
    without the user annotations (such as ``Optimizer.step``), whose spans
    would count their kernels' time twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


# Where a train step's device time goes: the first class whose pattern is in
# a kernel's name.
KERNEL_CLASSES = (
    ("port kernels", tuple(KERNEL_SYMBOLS.values())),
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("convolutions and GEMMs", ("xmma", "gemm", "Gemm", "conv", "fft", "grad_engine",
                                "implicit", "cutlass", "winograd", "complex")),
    ("copies and casts", ("copy",)),
    ("elementwise and reductions", ("elementwise", "reduce", "pool", "norm", "softmax")),
)


def classify_kernel(name: str) -> str:
    return next((cls for cls, pats in KERNEL_CLASSES if any(p in name for p in pats)), "other")


def device_ms(fn, symbol: str | None, iters: int = 20, launches: int = 1) -> float | None:
    """Device time per call of ``fn`` by torch.profiler: the kernels whose
    name holds ``symbol`` (every kernel when None). Unlike back-to-back CUDA
    events, this does not count the host's pace between launches. Each
    session has a warm-up step before the recorded one (the tracer tends to
    lose the first launches after it starts), and counts only if it recorded
    all ``launches`` kernels of each call (at least one per call when
    ``symbol`` is None); else it runs again, twice at most, and then the
    time is None, "not measured"."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        mine = [e for e in kernel_events(prof) if symbol is None or symbol in e.key]
        got = sum(e.count for e in mine)
        if got >= iters * launches:
            return sum(e.self_device_time_total for e in mine) / 1e3 / iters
        PROFILER_MISSES.append((symbol, got, iters * launches))
    return None


PROFILER_MISSES: list[tuple] = []  # (symbol, kernels recorded, kernels launched) per failed session


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


def time_path(label: str, calls: dict[tuple, int], gen: torch.Generator, card: str):
    """Each kernel of ``calls`` (recorded call -> calls per batch or step)
    against its plain version and yardstick by events, summed as often as
    the path makes each call; the largest shapes also by the profiler; each
    kernel's device sum over the path under one profiler session; and each
    wrapper's host time at its smallest shape. Returns (sums, rows, host)."""
    names = [n for n in KERNELS if any(c[0] == n for c in calls)]
    sums = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, lib_all=True,
                       bytes_ms=0.0, ops_ms=0.0, device_ms=0.0) for name in names}
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
    for name in names:
        mine = sorted((r for r in rows if r["op"] == name), key=lambda r: -r["bytes"])
        for r in mine[:TOP_SHAPES[name]]:
            call = next(c for c in calls if c[0] == name and list(c[1]) == r["shape"]
                        and dict(c[4]) == r["args"])
            x, arg, kw = inputs[call]
            r["device_ms"] = device_ms(lambda: run_kernel(call, x, arg, kw), KERNEL_SYMBOLS[name])
            lib = run_library(call, x, arg, kw)
            r["library_device_ms"] = device_ms(lib, None) if lib is not None else None
            if r["device_ms"]:
                r["device_gb_per_s"] = r["bytes"] / r["device_ms"] / 1e6
                r["device_share"] = r["bound_ms"] / r["device_ms"]
                rate = (f"{r['device_gb_per_s']:.0f} GB/s, {100 * r['device_share']:.1f}% of "
                        "the bound")
            else:
                rate = "GB/s and share of the bound not measured"
            say("timings", f"{label} {name} {tuple(r['shape'])} {r['args']} x{r['calls']}: "
                f"kernel {r['ms']:.4f} ms by events, {fmt_ms(r['device_ms'])} device "
                f"(profiler); {rate}; bound {r['bound_ms']:.4f} ms ({r['bound_by']}); plain "
                f"{r['plain_ms']:.4f} ms; "
                + (f"library {fmt_ms(r['library_ms'])} by events, "
                   f"{fmt_ms(r['library_device_ms'])} device" if lib is not None
                   else "library none (no one-call equivalent)") + f"; {card}")
    # Device sum of each kernel over the path: every call, as often as the
    # path makes it, under one profiler session.
    for name in names:
        mine = [(c, m) for c, m in calls.items() if c[0] == name]
        sums[name]["device_ms"] = device_ms(
            lambda: [run_kernel(c, *inputs[c]) for c, m in mine for _ in range(m)],
            KERNEL_SYMBOLS[name], iters=5, launches=sum(m for _, m in mine))
    say("timings", f"{label}, summed over the path's calls: " + "; ".join(
        f"{n}: kernel {s['ms']:.4f} ms by events, {fmt_ms(s['device_ms'])} device "
        f"(profiler), plain {s['plain_ms']:.4f} ms, bound {s['bound_ms']:.4f} ms, "
        f"library {format(s['library_ms'], '.4f') if s['lib_all'] else 'none'}"
        for n, s in sums.items()) + f"; {card}")
    # The wrappers' host cost at their smallest path shape.
    host = {}
    for name in names:
        call = min((c for c in calls if c[0] == name), key=lambda c: math.prod(c[1]))
        x, arg, kw = inputs[call]
        host[name] = dict(shape=list(call[1]), us=host_us(lambda: run_kernel(call, x, arg, kw)))
        say("timings", f"{label} {name} wrapper at {call[1]}: {host[name]['us']:.2f} us of "
            f"host time per call (1000 calls, one synchronise); {card}")
    inputs.clear()
    return sums, rows, host


def kernel_entry(name: str, s: dict, launches: int) -> dict:
    return {"name": name, "route": "cuda", **KERNELS[name], "launches": launches,
            "max_abs_err": None, "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"],
            "bound_by": "bytes" if s["bytes_ms"] >= s["ops_ms"] else "operations",
            "library_ms": s["library_ms"] if s["lib_all"] else None}


def phase_timings(models, path_calls: dict[str, dict[tuple, int]], launches: dict,
                  train_calls: dict[str, dict[tuple, int]], train_launches: dict,
                  device: dict) -> dict:
    """Serving: per reconstruct device batch; training: per train step. The
    kernels line carries bias_act and upfirdn2d per serving batch (as in
    earlier slices) and bias_act_grad per fp32 train step."""
    tf32_defaults(device)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    card = device["nvidia_smi"]
    kernels = {}
    detail = {}
    for dtype_name, calls in path_calls.items():
        sums, rows, host = time_path(f"{dtype_name} per reconstruct batch of {BATCH}", calls,
                                     gen, card)
        detail[dtype_name] = {"rows": rows, "sums": sums}
        detail[f"host_{dtype_name}"] = host
        if dtype_name == "float32":
            for name, s in sums.items():
                kernels[name] = kernel_entry(name, s, launches[name])
    for dtype_name, calls in train_calls.items():
        sums, rows, host = time_path(f"{dtype_name} per train step (batch {BATCH})", calls,
                                     gen, card)
        detail[f"train_{dtype_name}"] = {"rows": rows, "sums": sums, "host": host}
        if dtype_name == "float32":
            kernels["bias_act_grad"] = kernel_entry("bias_act_grad", sums["bias_act_grad"],
                                                    train_launches["bias_act_grad"])
    kernels = {name: kernels[name] for name in KERNELS}

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
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                engine.reconstruct(imgs)
            wall = (time.perf_counter() - t0) * 1e3
        events = kernel_events(prof)
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
    gen, lpips = train_modules()
    runs = {dtype: TrainRun(models, gen, lpips, dtype) for dtype in ("float32", "bfloat16")}
    train_calls = {dtype: run.record() for dtype, run in runs.items()}
    say("kernels", "path shapes: " + ", ".join(
        f"{label} {d}: {len(c)} distinct calls, {sum(c.values())} launches"
        for label, calls in (("per reconstruct batch", path_calls),
                             ("per train step", train_calls)) for d, c in calls.items()))
    worst = phase_kernels({**path_calls, **{f"train_{d}": c for d, c in train_calls.items()}})
    record["adjoint"] = phase_adjoint(train_calls["float32"])
    record["slice"] = phase_slice(models)
    record["cpu"] = phase_cpu(models)
    record["server"] = phase_server(models)
    tf32_defaults(record["device"])
    record["train"], train_launches = phase_train(runs, models, record["device"]["nvidia_smi"])
    del runs
    torch.cuda.empty_cache()
    record["train_cpu"] = phase_train_cpu(models, lpips)
    timings = phase_timings(models, path_calls, record["slice"]["launches"], train_calls,
                            train_launches, record["device"])
    record["timings"] = timings
    record["max_abs_err"] = worst
    record["profiler_misses"] = PROFILER_MISSES
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
