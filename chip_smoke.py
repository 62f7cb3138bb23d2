#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (viscoin_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                 # needs one CUDA card, a few minutes
    python3 chip_smoke.py --out run.json  # also writes every number to a file

Phases, each printed as it runs; any failure raises and exits non-zero. The
mp phase's processes start after phase 3; once they have taken their peak
memory, two lanes start, each a process of its own: the GAN lane (phases
12-13, and beside phase 13 the commands of phases 11 and 14) and the pipeline
lane (phases 15-18), beside the main process's phases 7, 8, 10 and 19-22
(phases 4-6 and 9 run before them, while the mp processes take their peaks). A
lane's lines are printed when it is joined, stamped with the main process's
clock; the main process joins the GAN lane before dp and the pipeline lane
after mp, and runs phase 23 alone:

  1. device    nvidia-smi name and power limit, torch and CUDA versions, and
               the TF32 flags (both set off for the correctness phases);
  2. build     nvcc builds every kernel source of csrc/ in parallel (three
               kernels: bias_act, its backward bias_act_grad, which is its
               second-order backward too, upfirdn2d),
               and g++ the native crop + resize of the data loader;
  3. kernels   each kernel against its plain torch version on the card, at
               every shape the serving path, the training step, a
               faithfulness-probe chunk (N = 32) and an amplify call
               (N = 2M + 1 = 9) give it (fp32 and bf16; the step's backward
               kernels and adjoint FIRs included) and on the test
               configurations: ragged tiles, 70000
               planes, the runtime-K instantiation (K = 2, 3, 5, 16),
               misaligned views; bias_act and bias_act_grad's dx bit-equal,
               db within 1e-5, upfirdn2d within 1e-5 (fp32) or 2e-2 (bf16)
               of the output's scale, and each call through its registered
               operator (torch.ops.viscoin.*, what a loaded artifact runs)
               bit-equal to the direct launch; then <y, A x> = <A^T y, x> for every
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
  7. export    sealed artifacts of the bundle (serve/export.py) in fp32 and
               bf16, traced on the card: export wall s and bytes, load s;
               against the live engine on 10 images, every output bit-equal
               under cuDNN's deterministic algorithms, one device batch's
               launches equal (classify and explain none), events ms per
               batch of each endpoint side by side, and one profiled batch
               of each: device ms, kernels and aten calls per batch, and
               the device ms by kernel class; `serve --from-artifact`
               in a fresh process per dtype: /v1/classify, /v1/reconstruct,
               /v1/explain against the live engine (within 1e-5 of the
               scale, 1 u8 level, the bit-equal ones named), /v1/amplify
               400, SIGINT: exit 0;
  8. train     the VisCoIN training step at flagship width (the bundle, a
               frozen original Generator with 2 mapping layers, LPIPS-VGG;
               batch 8 real + 8 synthetic, sampled 2 steps at a time), in
               float32 and bfloat16: exact launch counts of one pass through
               the step (a step that captures its CUDA graph runs a warm-up
               pass and a replay) and one sampler call, finite losses, a non-zero
               gradient on every trainable leaf, 3 + 10 steps on the host
               clock, peak memory, one step under torch.profiler;
  9. train-cpu one fp32 step's gradients at full width on 1 real + 1
               synthetic image, card against device="cpu";
10. loop      train_viscoin at flagship width on SyntheticDataset (200
               classes, 256², 64 train and 20 test images, the native
               loader with 8 threads, prefetch 1): run A (8 iterations,
               eval, checkpoint and probe every 4), run B (checkpoint every
               3, stopped after 4, resumed to 8: the same batches, step
               seeds and sampler seeds as A; under deterministic
               algorithms (cuDNN's, torch.use_deterministic_algorithms
               with warn_only, whose warnings are reported),
               bit-equal to A2, the unbroken run, in every loss and every
               tensor of the training state saved at step 7 (parameters,
               both Adam states) and of the final parameters; run B3, a
               resume that drops the Adam moments, must fail that check),
               run C
               (gradient accumulation 2: the parameters move after
               micro-steps 2 and 4 only), run D (device busy
               share over 3 profiled steps), run E (no cadences, 12
               iterations, the command's defaults: prefetch 1, 8 loader
               threads); exact launch counts of every
               run; the bundle the loop wrote reloads and reconstructs
               bit-equal to the bundle it saved; step, eval, checkpoint,
               probe and loader times, peak memory;
11. cli       `python -m viscoin_tpu_torch train viscoin` at 256² on the
               card in a temporary directory (3 iterations, then a resume
               to 4): the jsonl keys, the bundles and the training state;
12. gan       the `train gan` step at full width (256², z = w = 512, 2
               mapping layers, channel_base 16384, batch 16, mbstd group 4,
               ada_p 0.2), fp32 and bf16, at each cadence type (R1 with the
               path length, plain, path length, R1 alone): launches exactly
               those of the same step on the CPU at narrow widths, finite
               losses, R1 and the path length live on cadence, a non-zero
               gradient on every G and D leaf; every kernel call of those
               steps against its plain version (phase 3's tolerances; the
               second-order bias_act_grad calls with and without dy_add),
               <y, A x> = <A^T y, x> for its FIRs; the median step per
               cadence type, a 16-step cycle (launches exact; img/s, peak
               memory), one profiled step of each regulariser;
13. gan-cpu   one fp32 step with both regularisers at full width on 4
               images, card against device="cpu" (learning rate 0, noise
               strengths 0, the same draws and synthesis noise): losses, R1,
               path lengths and every G and D gradient; then R1's gradients
               alone for every D leaf; a control on the card with a planted
               fault in bias_act's second order must miss that check;
14. gan-cli   `python -m viscoin_tpu_torch train gan` at 256² in a
               temporary directory under cuDNN deterministic: 4 iterations
               (checkpoint and snapshot every 2), a resume to 6 within
               RESUME_RTOL of an unbroken run to 6 (beside both), and beside
               the resume `train viscoin` loading the exported EMA generator;
15. port      seeded sources in the reference's layouts at the manifests'
               full shapes (ResNet-50 with 200 and 10 classes, LPIPS-VGG,
               pytorch-fid Inception, the 256² NVlabs generator and
               discriminator in a fabricated network pickle), clean against
               the manifests; `port-weights --strict` on each (loaded on
               the card) to the commands' default paths; `--check` exits 1
               on a mis-shaped copy; each result on the card, exported and
               imported again, bit-equal to its source; `train viscoin`
               then reads the ported classifier, GAN and LPIPS (phase 15);
16. fid       Inception features card against the host CPU (TF32 at the
               defaults); the inception-nvlabs route (a traced full-width
               detector in that convention, ported, both compared on the
               card); `train gan --fid-every 2 --fid-samples 64` at 256²,
               full width, 3 iterations (one estimate), its FID against a
               recomputation from its export with the same draws; the FID
               sampling's launches against the CPU's count; beside it
               `train viscoin --fid-detector` on the ported pieces, one
               eval, finite fid_score; an Inception batch of 64 and an
               estimate of 64 fakes timed;
17. classifier one fp32 train step (ResNet-50, 200 classes, 256², batch
               8) card against the host CPU: loss, every gradient, the BN
               running statistics; the step at batch 32 in fp32 and bf16
               (median of 10 after 3, img/s, peak memory, busy share);
               `train classifier` from the ported classifier, then `test
               classifier` on its output (the best epoch's accuracy), which
               loads as `train viscoin` loads its classifier;
18. gan-tools the GAN tools at the JAX command's full widths, in the same
               directory (the ported 256² generator, LPIPS-VGG, Inception):
               `dataset-tool` packs 32 synthetic images at 256² (each member
               equals host_gan_transform of its source); `generate --seeds 0-15
               --batch-size 16` twice, bit-equal, the same seeds at other batch
               positions measured, 2 seeds card (TF32 off) against the host CPU
               within 1 u8 level; `style-mixing` with the defaults (the grid),
               and with every layer from the column seed (each cell its column
               image); `project --steps 100` (the loss falls), then the
               projector in-process: launches per step exactly those of the
               same projection on the CPU at narrow widths, every FIR at batch
               1 and every bias_act_grad without db, per-step ms, peak memory,
               busy share; 3 steps card against the host CPU (TF32 off, the
               same draws: step 0's gradients and the state after 3 steps) and
               a control under FirstOrderFault, a planted fault that check must
               catch; `fid --metric ppl` (TF32 off inside), its first 4
               segments card against the host CPU, with TF32 on beside it and
               through the JAX package's one-pass LPIPS form; `fid --dataset
               packed.zip --metric fid --metric kid --metric pr` (one host
               matrix square root; the features it used equal a recomputation);
19. analysis  the flagship bundle saved to a temporary directory: `python -m
               viscoin_tpu_torch serve --compute-dtype float32 --port 0` in a
               process of its own (its printed address; startup seconds),
               /v1/classify, /v1/reconstruct, /v1/explain and /v1/amplify
               against the in-process engine (1e-5 of the scale, 1 u8
               level), SIGINT: exit 0 with the batchers closed; explain on
               10 images in fp32 and bf16 (no kernel launch, two calls
               bit-equal, padding invariance, card vs CPU on 2 images within
               1e-3 and a wrong-class control that must fail it, an explain
               batch timed); test_concepts on 64 synthetic images (200
               classes, batch 32) card vs CPU within 1e-4 of the scale; the
               W+ pass (bias_act launches exactly the CPU's narrow count, no
               upfirdn2d; img/s); amplify-pca --pca 2's computation (launches
               exact, the mapping at N = 32 and the synthesis at N = 5 added
               to phase 3's shapes, one component card vs CPU within 1 u8
               level); amplify, amplify-pca --pca 2, concepts,
               concept-heatmaps and logs as commands with matplotlib
               unimportable: their 11 PNGs of their figures' sizes, every
               image panel the renderer's resampling of its array, amplify's
               within 1 u8 level of amplify_images in this process, launches
               exact, walls; to-pickle;
20. concept2clip beside the analysis phase's bundle, in a directory of its
               own: (a) CLIP ViT-B/32 at full width from seeded weights, every
               leaf perturbed: encode_image on 8 seeded 224² inputs and
               encode_text on 8 captions (a merges file learnt here from the
               captions) card (TF32 off) vs CPU within 1e-4 of the scale, the
               EOT rows, encode_image at batch 32 timed (median of 10 after 3,
               img/s, peak memory); (b) `port-weights clip` on seeded sources
               in the OpenAI and HF layouts at the manifests' full shapes
               (clean; --strict on the card; --check exits 1 on a mis-shaped
               copy; the written CLIP's embeddings bit-equal to an in-process
               conversion's); (c) `train concept2clip --dataset synthetic
               --epochs 3` at 256² (64 images per split) with --latent-type
               viscoin (no launch) and gan (the W+ pass: exactly the CPU's
               narrow count of bias_act, no upfirdn2d): the jsonl, the
               checkpoint and export-concept2clip bit-equal both ways, the
               walls of the CLIP pass, the space passes and each epoch; one
               epoch from the same caches card (TF32 off) vs CPU within 1e-5
               and the same matching accuracy, and a planted fault (the test
               loader unshuffled) that check must catch;
21. dp        data parallelism (parallel/mesh.py), see phase_dp: (a) `train
               viscoin` at flagship width under `torchrun --nproc-per-node 1`
               (NCCL at world size 1) against --no-data-parallel: jsonl records,
               the training state and the launches bit-equal; (b) two
               processes on the one card over gloo with CUDA tensors, the
               VisCoIN step (global batch 8 + 8) and the GAN step of every
               cadence type (global batch 16) against one process: metrics,
               first moments, parameters after the update, w_avg, pl_mean,
               r_t, each rank's launches; a planted fault (no gradient
               all-reduce) must fail; (c) `serve --data-parallel` on the one
               card bit-equal to the engine; wall time and peak memory per
               rank;
22. mp        model parallelism (parallel/spatial.py), see phase_mp: a (1
               data, 2 model) mesh of two processes on the one card over
               gloo at full width (batch 8 + 8) against one process in a
               process of its own (its VisCoIN steps eager, as the ranks'), started after phase 3, taking their
               peak memory with no other process on the card (the lanes
               wait for it), idle until dp, then beside dp's (a): the
               fp32 step's metrics and each network's gradient (TF32 off),
               the planted fault (every halo zeroed) caught, a bf16 step,
               each rank's launches those of one process, each rank's peak
               memory over the fp32 step at PyTorch's TF32 defaults at most
               0.8 of one process's (with TF32 off reported: missed, cuDNN's
               LPIPS workspace), the halo exchanges, gathers,
               scatters and model-group sums per step, 4 loop steps with a
               resume bit-equal; then the GAN trainer over the same mesh at
               the JAX command's width (256², z = w = 512, 2 mapping layers,
               batch 16, mbstd 4, ADA at p = 0.2): an R1 + path-length
               step and a plain one against one process (fp32, TF32 off:
               metrics, each network's gradient), the planted fault (the
               path-length gradient left un-reduced over the model group)
               caught, bf16, each rank's peak memory (taken before the
               lanes too), collectives and launches per step, and `train
               gan --model-parallel 2`'s training (the command's `_train`
               on the mesh) with a resume bit-equal to an unbroken run;
               every kernel call of the 2-D steps at its
               shard shape against its plain version (phase 3's tolerances);
23. timings   per kernel (CUDA events at the path's shapes, summed over the
               loop's run A, the GAN's 16-step cycle, one FID estimate, the
               projection's 100 timed steps, one PPL batch, amplify-pca --pca
               2 and train concept2clip's W+ pass as they made each call, and over one reconstruct
               batch or one train step) beside its plain version,
               a one-call PyTorch yardstick where one exists, and its
               memory/compute bound; for the largest shapes the profiler's
               device time, GB/s and share of the bound; the per-path device
               sum by the profiler (bias_act_grad's over both its kernels,
               bias_act_grad_kernel and, where a call sums db,
               bias_act_grad_db_kernel); each wrapper's host time per call at its
               smallest path shape, direct and through its registered
               operator (torch.ops.viscoin.*); the same for a probe chunk (N = 32) and
               an amplify call (N = 2M + 1 = 9); per endpoint latency, img/s
               and peak memory, and a torch.profiler breakdown of reconstruct;
24. the ``{"kernels": [...]}`` line: launches, ms, plain_ms, bound_ms and
               library_ms all over the loop's run A (``ms_over`` says so),
               the same over the GAN cycle (``gan_cycle_*``), one FID
               estimate (``fid_sampling_*``), the projection's timed steps
               (``projection_*``), one PPL batch (``ppl_batch_*``),
               amplify-pca --pca 2's computation (``amplify_pca_*``), the
               amplify command (``amplify_*``) and train concept2clip
               --latent-type gan's W+ pass (``concept2clip_w_*``),
               and each kernel's launches per mp step (``mp_step_launches``)
               and per mp GAN step (``mp_gan_step_launches``: the R1 +
               path-length step; ``mp_gan_plain_step_launches``);
               then the device line, last.

It imports torch and viscoin_tpu_torch only.
"""

from __future__ import annotations

import os

# cuBLAS is deterministic only with a fixed workspace, set before CUDA starts
# (the loop phase holds a resumed run bit-equal to the unbroken one).
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse
import contextlib
import copy
import importlib
import io
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from viscoin_tpu_torch import native
from viscoin_tpu_torch.data.datasets import SyntheticDataset
from viscoin_tpu_torch.data.loader import DataLoader
from viscoin_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD, device_preprocess
from viscoin_tpu_torch.eval import viscoin as TE
from viscoin_tpu_torch.models.bundle import default_models, init_models
from viscoin_tpu_torch.models.lpips import LPIPS
from viscoin_tpu_torch.models.stylegan import Generator
from viscoin_tpu_torch.ops import _kernels
from viscoin_tpu_torch.ops.upfirdn2d import setup_filter
from viscoin_tpu_torch.serve.engine import InferenceEngine
from viscoin_tpu_torch.serve.server import VisCoINServer
from viscoin_tpu_torch.train import gan as TG
from viscoin_tpu_torch.train.augment import augment
from viscoin_tpu_torch.train import viscoin as T
from viscoin_tpu_torch.train.viscoin import fold_seed
from viscoin_tpu_torch.utils import checkpoints as ckpt
from viscoin_tpu_torch.utils import exporting, porting
from viscoin_tpu_torch.utils import tracing
from viscoin_tpu_torch.utils.logging import configure_score_logging
from viscoin_tpu_torch.utils.weights import load_jax_tree, module_to_jax_tree

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
# bias_act_grad's db: the kernel sums in another (fixed) order than the
# plain version; relative to its scale, plus one rounding to the bias's type.
DB_TOL = 1e-5


_START = time.perf_counter()


def say(phase: str, msg: str) -> None:
    """One line of the phase's report, after the seconds since the script began."""
    print(f"[{phase} {time.perf_counter() - _START:.0f}s] {msg}", flush=True)


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
    t0 = time.perf_counter()
    assert native.available(), "the native crop + resize library did not build (g++)"
    say("build", f"native transform.cpp built with g++ into {native.BUILD_DIR} in "
        f"{time.perf_counter() - t0:.2f} s")
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
    the path runs, without changing what runs or synchronising the card. A
    call inside a CUDA graph's capture runs nothing: it is kept with its
    graph and recorded at each of that graph's replays, as the card runs it."""

    def __init__(self):
        self.calls: list[tuple] = []
        self._captured: list[tuple] = []  # calls of the capture under way
        self._graphs: dict[int, tuple] = {}  # id -> (graph, the calls it captured)
        self._orig = (ba._bias_act_cuda, ba._bias_act_grad_cuda, up._upfirdn2d_cuda,
                      torch.cuda.CUDAGraph.capture_end, torch.cuda.CUDAGraph.replay)

    def _add(self, call: tuple) -> None:
        (self._captured if torch.cuda.is_current_stream_capturing() else self.calls).append(call)

    def __enter__(self):
        orig_ba, orig_grad, orig_up, orig_end, orig_replay = self._orig
        rec = self

        def capture_end(graph):
            orig_end(graph)
            rec._graphs[id(graph)] = (graph, rec._captured)
            rec._captured = []

        def replay(graph):
            orig_replay(graph)
            assert id(graph) in rec._graphs, "a graph captured before the recorder started"
            rec.calls.extend(rec._graphs[id(graph)][1])

        def rec_ba(x, b, **kw):
            offset = x.data_ptr() % 16 // x.element_size()  # elements past 16-byte alignment
            self._add(("bias_act", tuple(x.shape), x.dtype,
                               (None if b is None else b.dtype, offset),
                               tuple(sorted(kw.items()))))
            return orig_ba(x, b, **kw)

        def rec_grad(x, b, dy, *, need_db=True, dy_add=None, **kw):
            offset = x.data_ptr() % 16 // x.element_size()
            self._add(("bias_act_grad", tuple(x.shape), x.dtype,
                               (None if b is None else b.dtype, offset, need_db,
                                dy_add is not None),
                               tuple(sorted(kw.items()))))
            return orig_grad(x, b, dy, need_db=need_db, dy_add=dy_add, **kw)

        def rec_up(x, f, **kw):
            taps = up._taps(f)  # the wrapper's cached read: no device sync per call
            kw = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
            self._add(("upfirdn2d", tuple(x.shape), x.dtype, taps,
                               tuple(sorted(kw.items()))))
            return orig_up(x, f, **kw)

        ba._bias_act_cuda, ba._bias_act_grad_cuda, up._upfirdn2d_cuda = rec_ba, rec_grad, rec_up
        torch.cuda.CUDAGraph.capture_end, torch.cuda.CUDAGraph.replay = capture_end, replay
        return self

    def __exit__(self, *exc):
        (ba._bias_act_cuda, ba._bias_act_grad_cuda, up._upfirdn2d_cuda,
         torch.cuda.CUDAGraph.capture_end, torch.cuda.CUDAGraph.replay) = self._orig

    def unique(self) -> dict[tuple, int]:
        out: dict[tuple, int] = {}
        for call in self.calls:
            out[call] = out.get(call, 0) + 1
        return out


def make_inputs(call: tuple, gen: torch.Generator):
    """(x, arg, kw) for a recorded call: arg is the bias (bias_act), (bias,
    dy, need_db, dy_add) (bias_act_grad; dy_add, the second order's g_db,
    where the call had one) or the taps (upfirdn2d). bias_act inputs lie on
    a 1/8 grid, so that the backward meets its ties (t = 0, y0 at the
    clamp)."""
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
        dy_add = torch.randn(shape[1], device="cuda", generator=gen) if extra[3] else None
        return x, (b, dy, extra[2], dy_add), dict(kw)
    x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    return x, torch.tensor(extra), dict(kw)


def run_kernel(call, x, arg, kw):
    if call[0] == "bias_act_grad":
        b, dy, need_db, dy_add = arg
        return ba._bias_act_grad_cuda(x, b, dy, need_db=need_db, dy_add=dy_add, **kw)
    return (ba._bias_act_cuda if call[0] == "bias_act" else up._upfirdn2d_cuda)(x, arg, **kw)


def run_op(call, x, arg, kw):
    """The same call through the registered operator ``torch.ops.viscoin.*``
    (what a loaded serving artifact runs)."""
    if call[0] == "bias_act_grad":
        b, dy, need_db, dy_add = arg
        return torch.ops.viscoin.bias_act_grad(x, b, dy, dy_add, kw["act"], kw["alpha"],
                                               kw["gain"], kw["clamp"], need_db)
    if call[0] == "bias_act":
        return torch.ops.viscoin.bias_act(x, arg, kw["act"], kw["alpha"], kw["gain"],
                                          kw["clamp"])
    return torch.ops.viscoin.upfirdn2d(x, list(up._taps(arg)), list(up._pair(kw["up"])),
                                       list(up._pair(kw["down"])),
                                       list(up.parse_padding(kw["padding"])),
                                       bool(kw["flip_filter"]), float(kw["gain"]))


def run_plain(call, x, arg, kw):
    if call[0] == "bias_act_grad":
        b, dy, need_db, dy_add = arg
        return ba.bias_act_grad_plain(x, b, dy, need_db=need_db, dy_add=dy_add, **kw)
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
    if (upy, upx) == (1, 1) and min(px0, px1, py0, py1) >= 0:
        # Down-sampling (the adjoint of an up-sampling FIR): a strided
        # depthwise conv on the padded input.
        w = (f2 * gain)[None, None].expand(c, 1, *f2.shape)
        return lambda: F.conv2d(F.pad(x, (px0, px1, py0, py1)), w, stride=(dny, dnx), groups=c)
    k = f2.shape[0]
    if (upy, upx, dny, dnx) == (2, 2, 1, 1) and f2.shape == (4, 4) and \
            (px0, px1, py0, py1) == (2, 1, 2, 1):
        # out[o] = sum_i x[i] f[2i + 2 - o]: a stride-2 transposed depthwise
        # conv with padding 1 and the filter reversed (true convolution).
        w = (f2.flip([0, 1]) * gain)[None, None].expand(c, 1, k, k)
        return lambda: F.conv_transpose2d(x, w, stride=2, padding=1, groups=c)
    return None


def record_eval_calls(models) -> dict[str, dict[tuple, int]]:
    """The kernel calls of the loop's new generator passes (fp32): one
    faithfulness-probe chunk (N = 32) and one amplify call (4 multipliers:
    N = 2M + 1 = 9); each is one generator pass, 42 bias_act and 12
    upfirdn2d launches (held exactly)."""
    per_pass = expected_launches(models)
    out = {}
    engine = InferenceEngine(models, batch_size=BATCH, device="cuda")
    for label, fn in (
            (f"per probe chunk of {TE.PROBE_BATCH}",
             lambda: TE.faithfulness_probe(models, seeded_images(TE.PROBE_BATCH, SEED + 60))),
            ("per amplify call (N = 9)",
             lambda: engine.amplify(seeded_images(1, SEED + 61)[0], {"method": "top_k", "k": 16},
                                    [0.0, 1.0, 2.0, 4.0]))):
        _kernels.reset_launch_counts()
        with PathRecorder() as rec:
            fn()
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
        assert counts == per_pass, (label, counts, per_pass)
        out[label] = rec.unique()
        n = {c[1][0] for c in out[label] if c[0] == "upfirdn2d"}
        assert n == {TE.PROBE_BATCH if "probe" in label else 9}, (label, n)
    del engine
    return out


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
                for offset in (0, 1):  # the second order's dy_add, both row modes
                    calls.append(("bias_act_grad", (8, 64, 32, 32), dtype,
                                  (dtype, offset, False, True), kw))
                    calls.append(("bias_act_grad", (8, 512), dtype,
                                  (dtype, offset, False, True), kw))
                for offset in (0, 1):
                    calls.append(("bias_act", (8, 64, 32, 32), dtype, (dtype, offset), kw))
                    calls.append(("bias_act", (8, 512), dtype, (dtype, offset), kw))
    calls.append(fir_call((1, 70000, 3, 3), torch.float32, f, up=1, down=1, padding=1, gain=1.0))
    return calls


def phase_kernels(path_calls: dict[str, dict[tuple, int]], configurations: bool = True) -> dict:
    """Returns, per kernel and dtype, the largest |kernel - plain| (over the
    calls of ``path_calls`` and, with ``configurations``, the test
    configurations)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {(name, dt): [0.0, 0.0] for name in KERNELS for dt in TOL}
    checks = [c for calls in path_calls.values() for c in calls]
    checks += test_configurations() if configurations else []
    for call in checks:
        x, arg, kw = make_inputs(call, gen)
        got = run_kernel(call, x, arg, kw)
        want = run_plain(call, x, arg, kw)
        # The registered operator (a loaded artifact's route) is the same launch.
        for a, b in zip(*(t if isinstance(t, tuple) else (t,)
                          for t in (run_op(call, x, arg, kw), got))):
            assert (a is None and b is None) or torch.equal(a, b), ("operator", call)
        torch.cuda.synchronize()
        if call[0] == "bias_act_grad":  # (dx, db): db sums in another order than the plain
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
    say("kernels", f"{len(checks)} kernel-vs-plain comparisons passed, each kernel "
        "bit-equal through its registered operator (the shapes of "
        f"{', '.join(path_calls)}"
        + (", and the test configurations" if configurations else "") + "; bias_act and "
        f"bias_act_grad's dx bit-equal, db within {DB_TOL:g} of its scale and one rounding); "
        "max |kernel - plain| (relative to max(1, max|plain|)): " + "; ".join(
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


# --------------------------------- phase 7 ---------------------------------- #

# The served artifact against the live engine where they are not bit-equal,
# of each output's scale (u8 within one level): a server process picks
# cuDNN's default, atomic algorithms for the generator's transposed
# convolutions, whose sums may land a rounding apart.
EXPORT_TOL = 1e-5


class ServeProcess:
    """``python -m viscoin_tpu_torch serve <args> --port 0`` in a process of
    its own, its output read on a thread: :meth:`wait_for` a line,
    :meth:`stop` by SIGINT (its exit code), :meth:`kill` whatever is left."""

    def __init__(self, args: list[str]):
        import queue

        self.lines: queue.Queue = queue.Queue()
        self.log: list[str] = []
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "viscoin_tpu_torch", "serve", *args, "--port", "0"],
            env=pipe_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self) -> None:
        for ln in self.proc.stdout:
            self.lines.put((time.perf_counter(), ln))
        self.lines.put(None)

    def wait_for(self, pattern: str, timeout: float = 300.0):
        """(the time the first line matching ``pattern`` came, its match)."""
        import re

        deadline = time.perf_counter() + timeout
        while True:
            item = self.lines.get(timeout=max(0.1, deadline - time.perf_counter()))
            if item is None:
                raise RuntimeError(f"serve exited {self.proc.wait()} before {pattern!r}:\n"
                                   + "".join(self.log)[-4000:])
            self.log.append(item[1])
            match = re.search(pattern, item[1])
            if match:
                return item[0], match

    def stop(self) -> int:
        import signal

        self.proc.send_signal(signal.SIGINT)
        code = self.proc.wait(timeout=120)
        self.reader.join(30)
        while (item := self.lines.get_nowait()) is not None:
            self.log.append(item[1])
        return code

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)


def _post(base: str, route: str, imgs: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, images=imgs)
    req = urllib.request.Request(base + route, data=buf.getvalue(),
                                 headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=300) as r:
        assert r.status == 200, (route, r.status)
        return r.read()


def _first_diff(a: dict, b: dict) -> dict[str, float]:
    """Each key's largest deviation of ``a`` from ``b`` (u8 in levels, the
    rest of ``b``'s scale)."""
    return {k: float(_u8_dev(a[k], b[k])) if b[k].dtype == np.uint8 else _rel(a[k], b[k])
            for k in b}


def export_served(srv: "ServeProcess", live, imgs: np.ndarray, dtype: str) -> dict:
    """The fresh process's /v1/classify, /v1/reconstruct and /v1/explain on
    ``imgs`` (one request each: the server batches them as the engine does)
    against the live engine; /v1/amplify answers 400; SIGINT ends it."""
    t_up, match = srv.wait_for(r"serving on (http://\S+)")
    base = match.group(1)
    with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
        health = json.loads(r.read())
    assert health["device"].startswith("cuda") and health["compute_dtype"] == dtype, health
    assert health["batch_size"] == BATCH, health
    dev: dict[str, float] = {}
    cls = json.loads(_post(base, "/v1/classify?top_k=5", imgs))
    want = live.classify(imgs)
    assert cls["preds"] == want["logits"].argmax(-1).tolist()
    assert cls["expl_preds"] == want["expl_logits"].argmax(-1).tolist()
    for key, idx, src in (("top_probas", "top_classes", "probas"),
                          ("top_expl_probas", "top_expl_classes", "expl_probas"),
                          ("top_concept_activations", "top_concepts", "concepts")):
        dev[f"classify {key}"] = _rel(cls[key], np.take_along_axis(
            want[src], np.asarray(cls[idx]), -1))
    rec = np.load(io.BytesIO(_post(base, "/v1/reconstruct", imgs)))
    want = live.reconstruct(imgs)
    dev["reconstruct u8"] = float(_u8_dev(rec["reconstruction_u8"], want["reconstruction_u8"]))
    expl = np.load(io.BytesIO(_post(base, "/v1/explain?top_k=5", imgs)))
    want = live.explain(imgs)
    np.testing.assert_array_equal(expl["expl_preds"], want["expl_preds"])
    for i in range(1, 6):
        dev[f"explain heatmap_conv{i}"] = _rel(expl[f"heatmap_conv{i}"], want[f"heatmap_conv{i}"])
    try:
        _post(base, "/v1/amplify?top_k_concepts=4", imgs[:1])
        raise AssertionError("/v1/amplify answered an artifact's server")
    except urllib.error.HTTPError as e:
        assert e.code == 400, e.code
    code = srv.stop()
    assert code == 0, (code, "".join(srv.log)[-3000:])
    assert any("micro-batchers closed" in ln for ln in srv.log), "".join(srv.log)[-3000:]
    for key, d in dev.items():
        assert d <= (1 if "u8" in key else EXPORT_TOL), (dtype, key, d)
    return {"up_s": t_up - srv.t0, "deviation": dev,
            "bit_equal": sorted(k for k, d in dev.items() if d == 0)}


def batch_profile(fn, iters: int = 3) -> dict | None:
    """One batch of ``fn`` under torch.profiler, averaged over ``iters``
    after a warm-up step: the device kernels' ms and count, the aten calls
    the host made (nested ones included) and the device ms by kernel class
    (``KERNEL_CLASSES``). None when the tracer recorded no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
    events = kernel_events(prof)
    if not events:
        return None
    by_class: dict[str, float] = {}
    for e in events:
        cls = classify_kernel(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + e.self_device_time_total / 1e3 / iters
    aten = sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CPU and e.key.startswith("aten::"))
    return {"device_ms": sum(e.self_device_time_total for e in events) / 1e3 / iters,
            "kernels": sum(e.count for e in events) / iters, "aten_calls": aten / iters,
            "by_class": by_class}


def phase_export(models, device: dict) -> dict:
    """Sealed artifacts of the flagship bundle (serve/export.py), in fp32
    and bf16, traced on the card: the export's wall s and bytes; the
    artifact loaded here (its s) against the live InferenceEngine on 10
    images, every output bit-equal under cuDNN's deterministic algorithms,
    the launches of one device batch of each endpoint equal (reconstruct's
    those of ``expected_launches``), events ms per batch of each endpoint
    against the live engine's, and one profiled batch of each (whether a gap
    is device work or the host's); `serve --from-artifact` in a fresh
    process per dtype (started as soon as its artifact is written), its
    answers against the live engine (TF32 at the defaults, as that process
    runs)."""
    from viscoin_tpu_torch.utils.cudnn import deterministic_cudnn
    from viscoin_tpu_torch.serve.export import ENDPOINTS, export_serving, load_exported

    card = device["nvidia_smi"]
    tf32_defaults(device)
    per_batch = expected_launches(models)
    want_launches = {"classify": {k: 0 for k in KERNELS}, "reconstruct": per_batch,
                     "explain": {k: 0 for k in KERNELS}}
    imgs = seeded_images(10, SEED + 93)
    root = tempfile.mkdtemp(prefix="viscoin_export_")
    out: dict = {}
    servers: dict[str, ServeProcess] = {}
    try:
        for dtype in ("float32", "bfloat16"):
            art = os.path.join(root, dtype)
            t0 = time.perf_counter()
            export_serving(models, art, batch_size=BATCH, compute_dtype=dtype,
                           platforms=("cuda",))
            out[dtype] = {"export_s": time.perf_counter() - t0, "bytes": {
                f: os.path.getsize(os.path.join(art, f)) for f in sorted(os.listdir(art))}}
            servers[dtype] = ServeProcess(["--from-artifact", art])
        for dtype in ("float32", "bfloat16"):
            res = out[dtype]
            t0 = time.perf_counter()
            eng = load_exported(os.path.join(root, dtype))
            res["load_s"] = time.perf_counter() - t0
            live = InferenceEngine(models, batch_size=BATCH, compute_dtype=dtype, device="cuda")
            b8 = imgs[:BATCH]
            launches = {}
            for label, e in (("artifact", eng), ("live", live)):
                for name in ENDPOINTS:
                    getattr(e, name)(b8)
                    _kernels.reset_launch_counts()
                    getattr(e, name)(b8)
                    torch.cuda.synchronize()
                    launches[f"{label} {name}"] = _kernels.launch_counts()
            for name in ENDPOINTS:
                assert launches[f"artifact {name}"] == launches[f"live {name}"] == \
                    want_launches[name], (dtype, name, launches)
            with deterministic_cudnn():
                for name in ENDPOINTS:
                    got, want = getattr(eng, name)(imgs), getattr(live, name)(imgs)
                    assert set(got) == set(want), (dtype, name)
                    diff = _first_diff(got, want)
                    assert all(d == 0 for d in diff.values()), (dtype, name, diff)
            # Host-bound batches whose pace moves with the host: alternate the
            # two (artifact, live, live, artifact, ...) and keep the medians.
            res["ms"] = {}
            for name in ENDPOINTS:
                times = {"artifact": [], "live": []}
                for label in ("artifact", "live", "live", "artifact") * 3:
                    e = eng if label == "artifact" else live
                    times[label].append(cuda_ms(lambda: getattr(e, name)(b8), iters=5,
                                                warmup=1))
                for label, t in times.items():
                    res["ms"][f"{name} {label}"] = statistics.median(t)
            res["profile"] = {f"{name} {label}": batch_profile(lambda: getattr(e, name)(b8))
                              for name in ENDPOINTS
                              for label, e in (("artifact", eng), ("live", live))}
            res["launches"] = {name: launches[f"artifact {name}"] for name in ENDPOINTS}
            res["served"] = export_served(servers[dtype], live, imgs, dtype)
            prof = res["profile"]
            if any(v is None for v in prof.values()):
                say("profile", f"export {dtype}: not measured (the tracer recorded no kernel "
                    f"in {[k for k, v in prof.items() if v is None]})")
            for name in ENDPOINTS:
                a, w = prof[f"{name} artifact"], prof[f"{name} live"]
                if a is None or w is None:
                    continue
                classes = sorted(set(a["by_class"]) | set(w["by_class"]),
                                 key=lambda c: -abs(a["by_class"].get(c, 0.0)
                                                    - w["by_class"].get(c, 0.0)))
                say("profile", f"export {dtype} {name}, one batch of {BATCH} (mean of 3) "
                    f"artifact / live: device {a['device_ms']:.3f} / {w['device_ms']:.3f} ms, "
                    f"kernels {a['kernels']:.1f} / {w['kernels']:.1f}, aten calls "
                    f"{a['aten_calls']:.0f} / {w['aten_calls']:.0f}; by class: "
                    + ", ".join(f"{c} {a['by_class'].get(c, 0.0):.3f} / "
                                f"{w['by_class'].get(c, 0.0):.3f}" for c in classes)
                    + f"; {card}")
            del eng, live
            torch.cuda.empty_cache()
            say("export", f"{dtype}: export_serving of classify, reconstruct, explain (batch "
                f"{BATCH}, traced on the card) {res['export_s']:.1f} s, "
                f"{sum(res['bytes'].values()) / 2**20:.1f} MiB ("
                + ", ".join(f"{f} {n / 2**20:.2f}" for f, n in res['bytes'].items())
                + f" MiB); loaded in {res['load_s']:.1f} s; against the live engine on 10 "
                f"images under deterministic cuDNN: every output bit-equal; launches per "
                f"device batch equal ({res['launches']['reconstruct']} on reconstruct, none on "
                f"classify and explain); events ms per batch of {BATCH} (medians of 6 "
                "alternating runs of 5), artifact / live: "
                + ", ".join(f"{n} {res['ms'][n + ' artifact']:.2f} / {res['ms'][n + ' live']:.2f}"
                            for n in ENDPOINTS)
                + f"; `serve --from-artifact` in its own process up in "
                f"{res['served']['up_s']:.1f} s, over HTTP against the live engine: "
                + ", ".join(f"{k} {d:.3g}" for k, d in res["served"]["deviation"].items())
                + f" (tolerance {EXPORT_TOL:g} of the scale, 1 u8 level; "
                f"{len(res['served']['bit_equal'])} of {len(res['served']['deviation'])} "
                f"bit-equal), /v1/amplify 400, SIGINT: exit 0; {card}")
    finally:
        for srv in servers.values():
            srv.kill()
        shutil.rmtree(root, ignore_errors=True)
    return out


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
        self.gen, self.lpips = gen, lpips
        self.release()
        self.sample = T.make_sample_fakes(gen, self.cfg)
        self.k = self.cfg.fake_presample_steps
        self.group, self.fakes = None, None
        self.images = torch.from_numpy(seeded_images(4 * BATCH, SEED + 40)).cuda()
        self.labels = torch.from_numpy(
            np.random.default_rng(SEED + 41).integers(0, N_CLASSES, 4 * BATCH)).cuda()

    def release(self) -> None:
        """A new step function: the old one's CUDA graph goes with it, and
        its private pool, which holds the step's activations, returns to
        the allocator (the gradients, which live in it, are dropped); the
        next step captures anew."""
        for grp in self.state.params.values():
            for p in grp.values():
                p.grad = None
        self.step_fn = T.make_train_step(self.models, self.gen, self.lpips, self.cfg,
                                         external_fakes=True)

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
        calls, forward and backward, per pass through the step's region (a
        step that captures its CUDA graph runs it GRAPH_WARMUP + 1 times:
        the warm-up and the replay)."""
        self.sample_if_needed()
        tracing.reset_graph_counts()
        with PathRecorder() as rec:
            self.step()
        torch.cuda.synchronize()
        passes = step_passes()
        calls = rec.unique()
        assert passes > 0 and all(m % passes == 0 for m in calls.values()), (passes, calls)
        self.release()  # the mp processes take their peaks before the step runs again
        return {c: m // passes for c, m in calls.items()}


def step_passes() -> int:
    """Passes the card ran through the VisCoIN step's region (preprocess to
    backward, where the kernels launch) since the graph counter's reset:
    GRAPH_WARMUP warm-up passes per capture (the capture runs nothing), one
    per replay and one per eager step."""
    counts = tracing.graph_counts()
    return T.GRAPH_WARMUP * counts["captures"] + counts["replays"] + counts["eager"]


def phase_adjoint(calls: dict[tuple, int], label: str = "the train step's") -> float:
    """<y, A x> = <A^T y, x> on the card for every FIR of ``calls`` (fp32;
    the forward geometries and their adjoints), A^T through autograd, which
    launches the kernel with the adjoint geometry. Returns the largest
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
    say("adjoint", f"<y, A x> = <A^T y, x> on the card for {label} {n} FIR "
        f"geometries (forward and adjoint), fp32: largest |difference| / (|y| |A x|) "
        f"{worst:.3e} (tolerance 1e-6)")
    return worst


def phase_train(runs: dict[str, TrainRun], models, card: str,
                calls: dict[str, dict[tuple, int]]) -> tuple[dict, dict]:
    """For each dtype: exact launch counts of one pass through the step's
    region (``calls``, the recorded step) and of one sampler call, a step
    launching that per pass (a replay of its CUDA graph one),
    the grad_fn of each wrapper's CUDA output, finite losses and a non-zero
    gradient on every trainable leaf; then TRAIN_WARMUP + TRAIN_STEPS steps
    timed on the host clock (each step ends by reading its loss), peak
    memory, and one step under torch.profiler (``calls``: each dtype's
    recorded step, the kernels that session must hold). Returns (record,
    the fp32 step's launch counts)."""
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
        tracing.reset_graph_counts()
        metrics = run.step()
        step_counts = _kernels.launch_counts()
        passes = step_passes()
        per_pass = {n: sum(m for c, m in calls[dtype].items() if c[0] == n) for n in KERNELS}
        assert per_pass == step_want, (dtype, per_pass, step_want)
        assert step_counts == {k: v * passes for k, v in step_want.items()}, (
            dtype, step_counts, passes, step_want)
        assert sampler_counts == sampler_want, (dtype, sampler_counts, sampler_want)
        values = {k: float(v) for k, v in metrics.items()}
        assert all(math.isfinite(v) for v in values.values()), values
        zero = [f"{g}.{n}" for g, grp in run.state.params.items() for n, p in grp.items()
                if p.grad is None or not float(p.grad.abs().max()) > 0
                or not torch.isfinite(p.grad).all()]
        assert not zero, (dtype, zero)
        n_leaves = sum(len(grp) for grp in run.state.params.values())
        say("train", f"{dtype}: one pass through the step launched {per_pass} (expected "
            f"{step_want}), the step after it {step_counts} ({passes} passes: "
            f"{dict(tracing.graph_counts())}); the "
            f"sampler ({run.k} x {BATCH} images) launched {sampler_counts}; losses "
            + ", ".join(f"{k} {v:.4f}" for k, v in values.items())
            + f"; all {n_leaves} trainable leaves of Psi, Theta and the mapping have finite, "
            "non-zero gradients")
        if dtype == "float32":
            launches = per_pass

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
        rec["profile"] = profile_step(run, dtype, kernels_want(calls[dtype]))
        run.release()  # the lanes share the card: no graph held past its dtype
        record[dtype] = rec
    return record, launches


def profile_step(run: TrainRun, dtype: str, want: dict[str, int]) -> dict:
    """Device time by kernel and by class of kernel over one train step (the
    sampler runs before the window); a session counts only if it recorded
    device kernel of the port's wrappers (``want``, from kernels_want)."""
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


# ------------------------------- the loop phase ------------------------------ #

LOOP_N_TRAIN, LOOP_N_TEST = 64, 20  # 20 test images: the third eval batch is ragged
EVAL_BATCHES = math.ceil(LOOP_N_TEST / BATCH)
# Run B (resumed) against run A2 (unbroken): both make the same calls on the
# same data and seeds. Under PyTorch's defaults (cuDNN's non-deterministic
# weight gradients) two identical runs drift apart by 1e-3 of the loss within
# 4 steps: Adam's first updates (lr * g / |g|) turn any gradient difference
# near zero into a step of lr. So B and A2 run with cuDNN's deterministic
# algorithms and under torch.use_deterministic_algorithms(True, warn_only=True),
# whose warnings name any operation that still has no deterministic version
# (cuBLAS's workspace is fixed by CUBLAS_WORKSPACE_CONFIG, set before CUDA
# starts). The concept extractor's 3x3 pooling is two matrix products (its
# adaptive_avg_pool2d's backward added with atomics), so every loss and every
# tensor of the state and of the final parameters is held bit-equal to A2's;
# run B3 plants a fault (the resume drops the Adam moments) and must fail
# that. ``tree_deviation`` reports ||B - A2|| / ||A2|| per tensor.
# The GAN command's resume (phase gan-cli) is held within RESUME_RTOL.
RESUME_RTOL = 1e-5
WATCHED = (("explainer", "linear.weight"), ("mapping", "fixed_w_avg"),
           ("concept_extractor", "conv5.weight"))


class RecordingLoader(DataLoader):
    """Remembers the dataset indices of every batch it builds, keyed by the
    batch's per-image byte sums (what the step sees)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.made: dict[tuple, list[int]] = {}

    def _make_batch(self, indices, pool):
        images, labels = super()._make_batch(indices, pool)
        key = tuple(images.reshape(len(images), -1).sum(1, dtype=np.int64).tolist())
        self.made[key] = [int(i) for i in indices]
        return images, labels


class LoopRecorder:
    """While a train_viscoin run is in flight, records per step its index,
    the u8 batch's per-image sums, the step seed and loss (and, with
    ``watch``, the watched parameters before and after); every sampler
    seed group; the bundle each save_viscoin saved; the seconds of each
    background install. Changes nothing that runs."""

    def __init__(self, watch: bool = False):
        self.watch = watch
        self.steps: list[dict] = []
        self.sampler: list[tuple] = []
        self.saved: dict[str, dict] = {}
        self.installs: list[float] = []
        self._orig = (T.make_train_step, T.fake_sample_keys, ckpt.save_viscoin,
                      ckpt._atomic_install)

    def __enter__(self):
        make, keys, save, install = self._orig
        rec = self

        def make_step(*args, **kw):
            step = make(*args, **kw)

            def wrapped(state, frozen, images_u8, labels, rng, fake=None, dropout_mask=None):
                entry = {"i": state.step, "seed": rng.initial_seed(),
                         "sums": images_u8.reshape(images_u8.shape[0], -1).sum(
                             1, dtype=torch.int64)}
                if rec.watch:
                    entry["before"] = [state.params[g][n].detach().clone() for g, n in WATCHED]
                state, metrics = step(state, frozen, images_u8, labels, rng, fake, dropout_mask)
                entry["loss"] = metrics["total_loss"]
                if rec.watch:
                    entry["after"] = [state.params[g][n].detach().clone() for g, n in WATCHED]
                rec.steps.append(entry)
                return state, metrics

            return wrapped

        def sample_keys(seed, group_start, k, mesh=None):
            out = keys(seed, group_start, k, mesh)
            rec.sampler.append((group_start, tuple(out)))
            return out

        def save_viscoin(models, path, async_save=False):
            rec.saved[path] = {k: v.detach().clone() for k, v in models.state_dict().items()}
            return save(models, path, async_save=async_save)

        def timed_install(path, write_fn):
            t0 = time.perf_counter()
            install(path, write_fn)
            rec.installs.append(time.perf_counter() - t0)

        T.make_train_step, T.fake_sample_keys = make_step, sample_keys
        ckpt.save_viscoin, ckpt._atomic_install = save_viscoin, timed_install
        return self

    def __exit__(self, *exc):
        T.make_train_step, T.fake_sample_keys, ckpt.save_viscoin, ckpt._atomic_install = \
            self._orig

    def batches(self, loader: RecordingLoader) -> list[list[int]]:
        return [loader.made[tuple(e["sums"].tolist())] for e in self.steps]

    def losses(self) -> list[float]:
        return [float(e["loss"]) for e in self.steps]


def loop_data():
    return (SyntheticDataset(n=LOOP_N_TRAIN, n_classes=N_CLASSES, image_size=RES, mode="train"),
            SyntheticDataset(n=LOOP_N_TEST, n_classes=N_CLASSES, image_size=RES, mode="test"))


def loop_run(models, gen, lpips, ckpt_dir: str, log: str, cfg_kw: dict, run_kw: dict,
             watch: bool = False, threads: int = 8):
    """One train_viscoin call on a copy of the bundle, with the launch
    counts and the graph counter reset just before and read just after
    (the timings' "graph"); ``threads``: the train loader's."""
    m = copy.deepcopy(models)
    train_ds, test_ds = loop_data()
    tl = RecordingLoader(train_ds, BATCH, seed=SEED, num_threads=threads)
    el = DataLoader(test_ds, BATCH, shuffle=False, num_threads=8)
    assert tl.use_native and el.use_native, "the loaders must take the native path"
    cfg = T.VisCoINTrainingParams(batch_size=BATCH, **cfg_kw)
    configure_score_logging(os.path.join(ckpt_dir, log))
    timings: dict = {}
    torch.cuda.synchronize()
    with LoopRecorder(watch) as rec:
        _kernels.reset_launch_counts()
        tracing.reset_graph_counts()
        T.train_viscoin(m, gen, lpips, tl, el, cfg, seed=SEED, checkpoint_dir=ckpt_dir,
                        timings=timings, device="cuda", **{"prefetch": 1, **run_kw})
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
    timings["graph"] = dict(tracing.graph_counts())
    return m, rec, timings, counts, tl


def loop_expected(step: dict, sampler: dict, per_pass: dict, timings: dict, steps: int,
                  samplers: int, eval_batches: int, probe_chunks: int) -> dict[str, int]:
    """Launches of a loop run of ``steps`` steps (``timings`` its loop_run's):
    the passes through the step's region (the warm-up before the first
    step's capture, then every step a replay of the CUDA graph; the run
    starts before the cd_fid_iteration gate and stays on its side), sampler
    calls, and one generator pass per eval batch and per probe chunk."""
    assert timings["graph"] == {"captures": 1, "replays": steps}, timings["graph"]
    passes = eval_batches + probe_chunks
    return {k: step[k] * (T.GRAPH_WARMUP + steps) + sampler[k] * samplers + per_pass[k] * passes
            for k in step}


def tree_deviation(a, b, path: str = "") -> dict[str, float]:
    """||a - b|| / ||b|| for every floating tensor (Adam's step counts
    included) of two nests of dicts, lists, tensors and scalars; everything
    else (keys, lengths, shapes, dtypes, integer tensors, scalars) must be
    equal."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(map(str, a)))
        return {k: v for key in a for k, v in tree_deviation(a[key], b[key],
                                                            f"{path}/{key}").items()}
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        return {k: v for i, (x, y) in enumerate(zip(a, b))
                for k, v in tree_deviation(x, y, f"{path}/{i}").items()}
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and (a.dtype, a.shape) == (b.dtype, b.shape), path
        if not a.is_floating_point():
            assert torch.equal(a, b), (path, a, b)
            return {}
        a, b = a.detach().double(), b.detach().double()
        return {path: float((a - b).norm() / b.norm().clamp_min(1e-30))}
    assert a == b, (path, a, b)
    return {}


def resume_deviation(dir_x: str, m_x, loss_x: list, dir_ref: str, m_ref, loss_ref: list):
    """A resumed run against the unbroken one: relative deviations of the
    losses of steps 5-8, of every tensor of the training state both saved
    at step 7 (parameters, both Adam states), and of the final trainable
    parameters."""
    states = [torch.load(os.path.join(d, "train_state", "train_state.pt"), weights_only=True)
              for d in (dir_x, dir_ref)]
    assert states[0]["step"] == states[1]["step"] == 7, [s["step"] for s in states]
    trained = [{g: dict(mod.named_parameters()) for g, mod in T.trainable_modules(m).items()}
               for m in (m_x, m_ref)]
    return {"loss": {f"step {5 + i}": abs(x - r) / abs(r)
                     for i, (x, r) in enumerate(zip(loss_x, loss_ref, strict=True))},
            "state": tree_deviation(*states), "final": tree_deviation(*trained)}


class AdamMomentsDropped:
    """A planted fault for the resume check: the loop's restore_train_state
    restores everything, then both Adams start again from empty states."""

    def __enter__(self):
        self._orig = restore = ckpt.restore_train_state

        def faulty(state, *args, **kw):
            state = restore(state, *args, **kw)
            for opt in (state.opt, state.gan_opt):
                opt.state.clear()
            return state

        ckpt.restore_train_state = faulty
        return self

    def __exit__(self, *exc):
        ckpt.restore_train_state = self._orig


def read_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def check_records(records: list[dict], n: int, label: str) -> None:
    """Every record has the train_* and test_* keys of the JAX loop, finite
    (FID is None: no detector)."""
    train_keys = {f"train_{k}" for k in T.TRAIN_METRICS}
    test_keys = {f"test_{k}" for k in ("acc_loss", "cr_loss", "of_loss", "lp_loss",
                                       "rec_loss_l1", "rec_loss_l2", "preds_overlap",
                                       "correct_preds", "correct_expl_preds", "fid_score")}
    assert len(records) == n, (label, len(records), n)
    for rec in records:
        assert set(rec) == train_keys | test_keys, (label, sorted(rec))
        assert rec["test_fid_score"] is None
        assert all(math.isfinite(v) for k, v in rec.items() if k != "test_fid_score"), rec


def busy_share(trace_path: str) -> tuple[float, float, int]:
    """(kernel ms, window ms, kernels) of a torch.profiler chrome trace: the
    device's kernel time over the span of everything the trace recorded."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e.get("dur", 0) for e in events)
    return sum(e["dur"] for e in kernels) / 1e3, (end - start) / 1e3, len(kernels)


def phase_loop(models, gen, lpips, isolated: dict, card: str) -> dict:
    """train_viscoin at flagship width: runs A-D (see the module docstring)."""
    step_want, sampler_want = expected_train_launches(models, 2)
    per_pass = {k: v for k, v in expected_launches(models).items()}
    tmp = tempfile.mkdtemp(prefix="viscoin_loop_")
    out: dict = {}
    try:
        # The loader alone: 3 epochs (the first decodes and caches), img/s of the last 2.
        train_ds, _ = loop_data()
        loader = DataLoader(train_ds, BATCH, seed=SEED, num_threads=8)
        list(loader)
        t0 = time.perf_counter()
        n_img = sum(b[0].shape[0] for _ in range(2) for b in loader)
        out["loader_img_per_s"] = n_img / (time.perf_counter() - t0)

        kw_a = dict(eval_every=4, checkpoint_every=4, faithfulness_every=4)
        torch.cuda.reset_peak_memory_stats()
        dir_a = os.path.join(tmp, "a")
        os.makedirs(dir_a)
        with PathRecorder() as path_a:  # every kernel call of run A, for phase 11
            m_a, rec_a, tim_a, counts_a, tl_a = loop_run(models, gen, lpips, dir_a, "a.jsonl",
                                                         dict(iterations=8), kw_a)
        out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        want_a = loop_expected(step_want, sampler_want, per_pass, tim_a, 8, 4,
                               2 * EVAL_BATCHES, 1)
        assert counts_a == want_a, ("run A launches", counts_a, want_a)
        calls_a = path_a.unique()
        recorded = {n: sum(m for c, m in calls_a.items() if c[0] == n) for n in KERNELS}
        assert recorded == counts_a, ("run A's recorded calls", recorded, counts_a)
        assert [tim_a.get(f"n_{p}") for p in ("steps", "eval", "checkpoint", "probe")] == \
            [8, 2, 2, 1], tim_a
        check_records(read_jsonl(os.path.join(dir_a, "a.jsonl")), 2, "run A")
        with open(os.path.join(dir_a, "a.jsonl")) as f:
            out["jsonl_a"] = f.read()  # the analysis phase's `logs` reads it
        assert {"viscoin0-2", "viscoin1-2", "train_state"} <= set(os.listdir(dir_a))

        # The bundle the loop wrote at i = 4 against the bundle it saved then.
        path = os.path.join(dir_a, "viscoin1-2")
        saved = rec_a.saved[path]
        reloaded = ckpt.load_viscoin_bundle(path, device="cuda")
        rsd = reloaded.state_dict()
        assert set(rsd) == set(saved)
        assert all(torch.equal(rsd[k], saved[k]) for k in saved)
        ref = copy.deepcopy(models)
        ref.load_state_dict(saved)
        imgs = seeded_images(BATCH, SEED + 70)
        got = InferenceEngine(reloaded, batch_size=BATCH, device="cuda")
        want = InferenceEngine(ref, batch_size=BATCH, device="cuda")
        rec_got, rec_want = got.reconstruct(imgs), want.reconstruct(imgs)
        for k in rec_want:
            np.testing.assert_array_equal(rec_got[k], rec_want[k])
        np.testing.assert_array_equal(got.classify(imgs)["logits"],
                                      want.classify(imgs)["logits"])
        say("loop", f"run A (8 iterations; eval, checkpoint, probe every 4): launches {counts_a} "
            f"= expected {want_a} (8 steps: {tim_a['graph']}, {T.GRAPH_WARMUP + 8} passes "
            f"through the step; 4 sampler calls, {2 * EVAL_BATCHES} eval batches, "
            "1 probe chunk); 2 jsonl records with every train_*/test_* key, finite; the bundle "
            "viscoin1-2 reloads through load_viscoin_bundle with every tensor equal to the one "
            "saved and reconstructs bit-equal (u8, predictions, logits) on the card")
        del reloaded, ref, got, want, saved
        rec_a.saved.clear()

        # Run B: checkpoint every 3 (state saved after i = 3, step 4), stop
        # after 4, resume to 8; and run A2, run A again unbroken. Both with
        # cuDNN's deterministic algorithms (see WATCHED's comment). Each
        # saves its training state last after i = 6 (step 7).
        dir_b = os.path.join(tmp, "b")
        os.makedirs(dir_b)
        kw_b = dict(kw_a, checkpoint_every=3)
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        caught = warnings.catch_warnings(record=True)
        nondeterministic = caught.__enter__()
        warnings.simplefilter("always")
        try:
            _, rec_b1, tim_b1, counts_b1, tl_b1 = loop_run(models, gen, lpips, dir_b, "b1.jsonl",
                                                      dict(iterations=8),
                                                      dict(kw_b, stop_after=4))
            state = torch.load(os.path.join(dir_b, "train_state", "train_state.pt"),
                               weights_only=True)
            assert state["step"] == 4, state["step"]
            dir_b3 = os.path.join(tmp, "b3")  # B1's state, for the planted fault (run B3)
            shutil.copytree(os.path.join(dir_b, "train_state"),
                            os.path.join(dir_b3, "train_state"))
            m_b, rec_b2, tim_b2, counts_b2, tl_b2 = loop_run(
                models, gen, lpips, dir_b, "b2.jsonl", dict(iterations=8),
                dict(kw_b, resume_from=os.path.join(dir_b, "train_state")))
            dir_a2 = os.path.join(tmp, "a2")
            os.makedirs(dir_a2)
            m_a2, rec_a2, _, _, _ = loop_run(models, gen, lpips, dir_a2, "a2.jsonl",
                                             dict(iterations=8), kw_b)
            with AdamMomentsDropped():  # run B3: B2 with a planted fault
                m_b3, rec_b3, _, _, _ = loop_run(
                    models, gen, lpips, dir_b3, "b3.jsonl", dict(iterations=8),
                    dict(kw_b, eval_every=0, faithfulness_every=0,
                         resume_from=os.path.join(dir_b3, "train_state")))
        finally:
            caught.__exit__(None, None, None)
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
        flagged = sorted({str(w.message).splitlines()[0][:200] for w in nondeterministic
                          if "deterministic" in str(w.message)})
        want_b1 = loop_expected(step_want, sampler_want, per_pass, tim_b1, 4, 2, EVAL_BATCHES, 0)
        want_b2 = loop_expected(step_want, sampler_want, per_pass, tim_b2, 4, 2, EVAL_BATCHES, 1)
        assert counts_b1 == want_b1, ("run B1 launches", counts_b1, want_b1)
        assert counts_b2 == want_b2, ("run B2 launches", counts_b2, want_b2)
        check_records(read_jsonl(os.path.join(dir_b, "b1.jsonl")), 1, "run B1")
        check_records(read_jsonl(os.path.join(dir_b, "b2.jsonl")), 1, "run B2")
        steps_b = rec_b1.steps + rec_b2.steps
        assert [e["i"] for e in steps_b] == [e["i"] for e in rec_a.steps] == list(range(8))
        batches_a = rec_a.batches(tl_a)
        batches_b = rec_b1.batches(tl_b1) + rec_b2.batches(tl_b2)
        assert batches_a == batches_b, (batches_a, batches_b)
        assert [e["seed"] for e in rec_a.steps] == [e["seed"] for e in steps_b] \
            == [e["seed"] for e in rec_a2.steps]
        assert rec_a.sampler == rec_b1.sampler + rec_b2.sampler == rec_a2.sampler, \
            "sampler seeds differ"
        loss_a, loss_a2 = rec_a.losses(), rec_a2.losses()
        loss_b = rec_b1.losses() + rec_b2.losses()
        rel_default = [abs(a - b) / abs(a) for a, b in zip(loss_a, loss_a2)]
        dev_b = resume_deviation(dir_b, m_b, loss_b[4:], dir_a2, m_a2, loss_a2[4:])
        dev_b3 = resume_deviation(dir_b3, m_b3, rec_b3.losses(), dir_a2, m_a2, loss_a2[4:])
        del m_b, m_a2, m_b3
        out["resume"] = dict(loss_a=loss_a, loss_a2=loss_a2, loss_b=loss_b,
                             rel_a_a2=rel_default, launches_b1=counts_b1, launches_b2=counts_b2,
                             deviation_b=dev_b, deviation_planted_fault=dev_b3,
                             nondeterministic_ops=flagged)
        worst_b = {k: max(v.values(), default=0.0) for k, v in dev_b.items()}
        worst_b3 = {k: max(v.values(), default=0.0) for k, v in dev_b3.items()}
        differ = {k: sorted(p for p, d in v.items() if d > 0) for k, v in dev_b.items()}
        say("loop", f"run B (checkpoint every 3, stopped after 4 at step 4, resumed to 8): "
            f"launches {counts_b1} then {counts_b2} (expected {want_b1}, {want_b2}); the same "
            f"8 batches of dataset indices, step seeds and {len(rec_a.sampler)} sampler seed "
            f"groups as runs A and A2; deterministic algorithms for B and A2 (operations "
            f"without one: {flagged or 'none'}): largest relative deviation from A2 "
            + ", ".join(f"{k} {v:.3e}" for k, v in worst_b.items())
            + f" (held bit-equal; tensors not bit-equal: {differ}); run B3 (the resume with "
            f"the Adam moments dropped, a planted fault): "
            + ", ".join(f"{k} {v:.3e}" for k, v in worst_b3.items())
            + f"; A (PyTorch's defaults) against A2, loss steps 5-8: max relative "
            f"{max(rel_default[4:]):.3e} (not held); A2's losses "
            + ", ".join(f"{v:.5f}" for v in loss_a2))
        assert max(worst_b.values()) == 0.0, ("run B is not bit-equal to A2", differ, dev_b)
        assert min(worst_b3[k] for k in ("state", "final")) > 0.0, \
            ("the resume check would miss dropped Adam moments", dev_b3)

        # Run C: gradient accumulation 2, 4 micro-steps.
        dir_c = os.path.join(tmp, "c")
        os.makedirs(dir_c)
        _, rec_c, tim_c, counts_c, _ = loop_run(
            models, gen, lpips, dir_c, "c.jsonl", dict(iterations=4, gradient_accumulation=2),
            dict(eval_every=0, checkpoint_every=0, faithfulness_every=0), watch=True)
        moved = [not all(torch.equal(a, b) for a, b in zip(e["before"], e["after"]))
                 for e in rec_c.steps]
        assert moved == [False, True, False, True], moved
        want_c = loop_expected(step_want, sampler_want, per_pass, tim_c, 4, 2, 0, 0)
        assert counts_c == want_c, ("run C launches", counts_c, want_c)
        say("loop", f"run C (gradient accumulation 2, 4 micro-steps): the watched parameters "
            f"({', '.join(f'{g}.{n}' for g, n in WATCHED)}) moved after micro-steps "
            f"{[i + 1 for i, mv in enumerate(moved) if mv]} only; launches {counts_c} = expected")

        # Run D: device busy share over 3 profiled steps (steps 2-4 of 5).
        dir_d = os.path.join(tmp, "d")
        os.makedirs(dir_d)
        _, _, tim_d, counts_d, _ = loop_run(
            models, gen, lpips, dir_d, "d.jsonl", dict(iterations=5),
            dict(eval_every=0, checkpoint_every=0, faithfulness_every=0,
                 profile_dir=os.path.join(dir_d, "prof")))
        assert counts_d == loop_expected(step_want, sampler_want, per_pass, tim_d, 5, 3, 0, 0), \
            counts_d
        kernel_ms, window_ms, n_kernels = busy_share(os.path.join(dir_d, "prof", "trace.json"))
        out["busy"] = dict(kernel_ms=kernel_ms, window_ms=window_ms, kernels=n_kernels)

        # Run E: the loop without cadences, 12 iterations, with the command's
        # defaults (prefetch 1, 8 loader threads): the steady state (steps
        # 3-12) against the isolated step.
        dir_e = os.path.join(tmp, "e")
        os.makedirs(dir_e)
        _, _, tim_e, counts_e, _ = loop_run(
            models, gen, lpips, dir_e, "e.jsonl", dict(iterations=12),
            dict(eval_every=0, checkpoint_every=0, faithfulness_every=0))
        assert counts_e == loop_expected(step_want, sampler_want, per_pass, tim_e, 12, 6, 0, 0)
        steady = {"prefetch 1, 8 loader threads": [1e3 * t for t in tim_e["seconds"]["steps"][2:]]}
        out["steady_step_ms"] = steady

        sec = tim_a["seconds"]
        step_ms = [1e3 * t for t in sec["steps"]]
        out.update(
            launches=counts_a, launches_per_step=step_want, launches_per_sampler=sampler_want,
            launches_per_pass=per_pass, step_ms=step_ms,
            step_ms_median=statistics.median(step_ms),
            img_per_s=BATCH * len(step_ms) / sum(sec["steps"]),
            eval_ms=[1e3 * t for t in sec["eval"]], checkpoint_ms=[1e3 * t for t in
                                                                    sec["checkpoint"]],
            probe_ms=[1e3 * t for t in sec["probe"]], install_ms=[1e3 * t for t in
                                                                   rec_a.installs])
        iso = isolated["float32"]
        say("loop", f"run A step median {out['step_ms_median']:.2f} ms (all 8 steps, sampler "
            f"calls included) against the isolated step {iso['step_ms_median']:.2f} ms, "
            f"{iso['ms_per_step_with_sampling']:.2f} ms with its sampler share (train phase); "
            f"steps {', '.join(f'{t:.1f}' for t in step_ms)} ms; {card}")
        say("loop", f"run A real img/s over its 8 steps: {out['img_per_s']:.1f}; {card}")
        for label, ms in steady.items():
            say("loop", f"run E (no cadences, {label}): steps 3-12 median "
                f"{statistics.median(ms):.2f} ms (min {min(ms):.2f}, max {max(ms):.2f}; sampler "
                f"calls included), {BATCH * len(ms) / sum(ms) * 1e3:.1f} real img/s; {card}")
        out["calls_a"] = calls_a  # tuple keys: main() takes it out before any JSON
        say("loop", f"eval: {', '.join(f'{t:.1f}' for t in out['eval_ms'])} ms per pass "
            f"({EVAL_BATCHES} batches of {BATCH}, the last ragged: "
            f"{statistics.mean(out['eval_ms']) / EVAL_BATCHES:.1f} ms per batch, mean); {card}")
        say("loop", f"checkpoint (bundle + training state): synchronous host snapshot "
            f"{', '.join(f'{t:.1f}' for t in out['checkpoint_ms'])} ms; background writes "
            f"{', '.join(f'{t:.0f}' for t in out['install_ms'])} ms per install; {card}")
        say("loop", f"faithfulness probe (20 images, one chunk of 32): "
            f"{', '.join(f'{t:.1f}' for t in out['probe_ms'])} ms; {card}")
        say("loop", f"loader alone (SyntheticDataset 256², native crop + resize, 8 threads): "
            f"{out['loader_img_per_s']:.1f} img/s; {card}")
        say("loop", f"peak memory over run A: {out['peak_mib']:.0f} MiB; {card}")
        say("loop", f"run D, steps 2-4 under torch.profiler: device kernels {kernel_ms:.1f} ms "
            f"of a {window_ms:.1f} ms window = {100 * kernel_ms / window_ms:.1f}% busy "
            f"({n_kernels} kernels); {card}")
        return out
    finally:
        ckpt.wait_for_saves()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_cli(card: str) -> dict:
    """`python -m viscoin_tpu_torch train viscoin` on the card at 256²,
    16 synthetic images, in a temporary directory: 3 iterations (eval and
    checkpoint every 2), then a resume to 4."""
    tmp = tempfile.mkdtemp(prefix="viscoin_cli_")
    repo = str(Path(__file__).resolve().parent)
    env = {k: v for k, v in os.environ.items() if k != "VISCOIN_SYNTH_SIZE"}
    env.update(VISCOIN_SYNTH_N="16", PYTHONPATH=repo + os.pathsep + env.get("PYTHONPATH", ""))
    base = [sys.executable, "-m", "viscoin_tpu_torch", "train", "viscoin", "--dataset",
            "synthetic", "--batch-size", "8", "--eval-every", "2", "--checkpoint-every", "2",
            "--faithfulness-every", "0"]
    out = {}
    try:
        for label, extra in (("first", ["--epochs", "3"]),
                             ("resume", ["--epochs", "4", "--resume", "train_state"])):
            t0 = time.perf_counter()
            res = subprocess.run(base + extra, cwd=tmp, env=env, capture_output=True, text=True,
                                 timeout=600)
            out[f"{label}_s"] = time.perf_counter() - t0
            if res.returncode != 0:
                raise RuntimeError(f"`train viscoin` ({label}) exited {res.returncode}:\n"
                                   f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
            if label == "first":
                check_records(read_jsonl(os.path.join(tmp, "viscoin_3.jsonl")), 2, "cli")
                state = torch.load(os.path.join(tmp, "train_state", "train_state.pt"),
                                   weights_only=True)
                assert state["step"] == 3, state["step"]
        files = set(os.listdir(tmp))
        assert {"viscoin0-1", "viscoin1-1", "train_state", "viscoin_3.jsonl",
                "viscoin_4.jsonl"} <= files, files
        say("cli", f"python -m viscoin_tpu_torch train viscoin --dataset synthetic --epochs 3 "
            f"--batch-size 8 --eval-every 2 --checkpoint-every 2 --faithfulness-every 0 at 256², "
            f"16 images, on the card: {out['first_s']:.1f} s, 2 jsonl records with every "
            f"train_*/test_* key, finite; bundles viscoin0-1 and viscoin1-1 and train_state "
            f"(step 3); the resume with --epochs 4: {out['resume_s']:.1f} s; {card}")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -------------------------------- the GAN phases ------------------------------ #

GAN_BATCH = 16  # GANTrainingParams.batch_size, the JAX command's default
GAN_SEED = SEED + 80
# The augmentation probability of the measured steps: a run past its start
# (ADA begins at p = 0, where no image is augmented and the warp is skipped).
GAN_ADA_P = 0.2
# The cadence types of one step: (label, step index, config changes). Step 0
# runs R1 and the path length, step 1 neither, step 4 the path length; R1
# alone needs the path length off (every R1 step, 16k, is a path-length
# step, 4j).
GAN_CADENCES = (("r1+ppl", 0, {}), ("plain", 1, {}), ("ppl", 4, {}),
                ("r1", 16, dict(ppl_weight=0.0)))
GAN_WARMUP, GAN_TIMED = 1, 3
GAN_CYCLE = 16  # one R1 step (with its path length), 3 more path-length steps, 12 plain
GAN_CPU_BATCH = 4  # the main path's mbstd group (min(4, 16)): the least batch with it
# Card vs CPU, as the VisCoIN step's: |difference| / the leaf's max |grad|,
# for every G and D leaf of the step and for R1's gradients alone.
GAN_GRAD_TOL = 1e-2
GAN_FAULT_ALPHA = 0.22  # SecondOrderFault's lrelu slope (the true one is 0.2)


def gan_modules():
    """The `train gan` generator and discriminator at full width (the JAX
    command's: 256², z = w = 512, 2 mapping layers, channel_base 16384,
    channel_max 512, mbstd group 4) from seeds, with constant leaves
    perturbed."""
    from viscoin_tpu_torch.cli.train import build_gan_modules

    g, d = build_gan_modules(RES, CHANNEL_BASE, CHANNEL_MAX, GAN_BATCH, device="cuda",
                             seed=GAN_SEED)
    perturb_constants(g, GAN_SEED + 2)
    perturb_constants(d, GAN_SEED + 3)
    return g, d


class GanRun:
    """One compute dtype's GAN training on the card: copies of G and D, the
    state (ada_p at GAN_ADA_P), the step (and an R1-only variant), four
    seeded u8 batches, cycled."""

    def __init__(self, g, d, dtype: str):
        from dataclasses import replace

        self.g, self.d = copy.deepcopy(g), copy.deepcopy(d)
        self.cfg = TG.GANTrainingParams(compute_dtype=dtype, augment_p=GAN_ADA_P,
                                        batch_size=GAN_BATCH)
        self.state = TG.create_gan_train_state(self.g, self.d, self.cfg)
        self.cfgs = {label: replace(self.cfg, **kw) for label, _, kw in GAN_CADENCES}
        self.steps = {label: TG.make_gan_train_step(self.g, self.d, c)
                      for label, c in self.cfgs.items()}
        self.images = torch.from_numpy(seeded_images(4 * GAN_BATCH, GAN_SEED + 4)).cuda()

    def run(self, i: int, label: str = "plain"):
        """Step ``i`` (the state's counter set to it) of cadence ``label``'s
        config (the default config for every label but "r1"). Returns
        (metrics, draws)."""
        cfg = self.cfgs[label]
        self.state.step = i
        draws = TG.draw_step(cfg, self.g, GAN_SEED, i, "cuda")
        rows = slice((i % 4) * GAN_BATCH, (i % 4 + 1) * GAN_BATCH)
        _, metrics = self.steps[label](self.state, self.images[rows], draws)
        return metrics, draws


def count_plain_calls(fn) -> dict[str, int]:
    """Calls of each kernel's plain version while ``fn`` runs on the CPU:
    the launches the same work makes on the card."""
    counts = {name: 0 for name in KERNELS}
    orig = (ba.bias_act_plain, ba.bias_act_grad_plain, up.upfirdn2d_plain)

    def counted(name, f):
        def wrapped(*args, **kw):
            counts[name] += 1
            return f(*args, **kw)
        return wrapped

    ba.bias_act_plain = counted("bias_act", orig[0])
    ba.bias_act_grad_plain = counted("bias_act_grad", orig[1])
    up.upfirdn2d_plain = counted("upfirdn2d", orig[2])
    try:
        fn()
    finally:
        ba.bias_act_plain, ba.bias_act_grad_plain, up.upfirdn2d_plain = orig
    return counts


class GanLaunchModel:
    """Exact launch counts of a GAN step, from the same step at the same
    resolution, mapping depth, batch, cadence and style-mixing cutoffs on the
    CPU at narrow widths (channel_base 256, channel_max 8, z = w = 8; no
    augmentation, which launches no kernel): one plain-version call per
    kernel launch."""

    def __init__(self):
        from viscoin_tpu_torch.models.stylegan import Discriminator

        self.g = init_models(Generator(z_dim=8, w_dim=8, img_resolution=RES, channel_base=256,
                                       channel_max=8, mapping_layers=2, device="cpu"), 1)
        self.d = init_models(Discriminator(img_resolution=RES, channel_base=256, channel_max=8,
                                           mbstd_group_size=4, device="cpu"), 2)
        self.images = torch.from_numpy(seeded_images(GAN_BATCH, GAN_SEED + 5))
        self.cache: dict[tuple, dict] = {}

    def __call__(self, i: int, cfg_kw: dict, cutoffs: tuple[int, int]) -> dict[str, int]:
        num_ws = 2 * int(math.log2(RES)) - 2  # a mixed call maps a second latent
        key = (i % 16 == 0, i % 4 == 0, tuple(sorted(cfg_kw.items())),
               tuple(c < num_ws for c in cutoffs))
        if key not in self.cache:
            cfg = TG.GANTrainingParams(augment="none", batch_size=GAN_BATCH, **cfg_kw)
            state = TG.create_gan_train_state(self.g, self.d, cfg)
            state.step = i
            draws = TG.draw_step(cfg, self.g, GAN_SEED, i, "cpu")
            draws.cutoff, draws.cutoff2 = cutoffs
            step = TG.make_gan_train_step(self.g, self.d, cfg)
            self.cache[key] = count_plain_calls(lambda: step(state, self.images, draws))
        return self.cache[key]


def phase_gan(g, d, card: str) -> tuple[dict, dict]:
    """The `train gan` step at full width on the card, fp32 and bf16: exact
    launch counts of each cadence type, finite losses, R1 and the path length
    live where on cadence, a non-zero gradient on every G and D leaf; the
    kernel calls of every cadence type recorded (for phase 3's checks); the
    median step per cadence type after warm-up; a 16-step cycle (its launches
    exact, recorded as the GAN's kernels-line path, then timed), its img/s and
    peak memory; one profiled step of each regulariser. Returns (record,
    {label: recorded calls})."""
    model = GanLaunchModel()
    out: dict = {"cadences": [c[:2] for c in GAN_CADENCES]}
    calls: dict[str, dict[tuple, int]] = {}
    cycle_calls = None
    num_ws = 2 * int(math.log2(RES)) - 2
    for dtype in ("float32", "bfloat16"):
        run = GanRun(g, d, dtype)
        rec: dict = {}
        for label, i, kw in GAN_CADENCES:
            torch.cuda.synchronize()
            _kernels.reset_launch_counts()
            with PathRecorder() as prec:
                metrics, draws = run.run(i, label)
            torch.cuda.synchronize()
            counts = _kernels.launch_counts()
            want = model(i, kw, (draws.cutoff, draws.cutoff2))
            assert counts == want, (dtype, label, counts, want)
            calls[f"gan {dtype} {label}"] = prec.unique()
            values = {k: float(v) for k, v in metrics.items()}
            assert all(math.isfinite(v) for v in values.values()), (dtype, label, values)
            assert (values["r1"] > 0) == (i % 16 == 0), (label, values)
            assert (values["pl_lengths"] > 0) == (label in ("r1+ppl", "ppl")), (label, values)
            # beta1 = 0: each Adam's first moment is the step's gradient.
            zero = [f"{who}.{n}" for who, module, opt in (("G", run.g, run.state.g_opt),
                                                         ("D", run.d, run.state.d_opt))
                    for n, p in module.named_parameters()
                    if not (float(opt.state[p]["exp_avg"].abs().max()) > 0
                            and bool(torch.isfinite(opt.state[p]["exp_avg"]).all()))]
            assert not zero, (dtype, label, zero)
            n_leaves = sum(1 for _ in run.g.parameters()) + sum(1 for _ in run.d.parameters())
            rec[label] = dict(step=i, launches=counts, cutoffs=(draws.cutoff, draws.cutoff2),
                              metrics=values)
            say("gan", f"{dtype} {label} (step {i}, style-mixing cutoffs {draws.cutoff}, "
                f"{draws.cutoff2} of {num_ws}): launches {counts} = expected (the same step "
                f"on the CPU at narrow widths); "
                + ", ".join(f"{k} {v:.4f}" for k, v in values.items())
                + f"; all {n_leaves} G and D leaves have finite, non-zero gradients")

        # The median step of each cadence type, on the host clock (reading
        # g_loss ends the step), with PyTorch's TF32 defaults.
        for label, i, _ in GAN_CADENCES:
            ms = []
            for it in range(GAN_WARMUP + GAN_TIMED):
                t0 = time.perf_counter()
                metrics, _ = run.run(i, label)
                float(metrics["g_loss"])
                if it >= GAN_WARMUP:
                    ms.append((time.perf_counter() - t0) * 1e3)
            rec[label]["step_ms"] = ms
            rec[label]["step_ms_median"] = statistics.median(ms)

        # The 16-step cycle: once recorded with the counts reset (the path of
        # the kernels line), then timed.
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        cutoffs = []
        with PathRecorder() as crec:
            for i in range(GAN_CYCLE):
                _, draws = run.run(i)
                cutoffs.append((draws.cutoff, draws.cutoff2))
        torch.cuda.synchronize()
        cycle_counts = _kernels.launch_counts()
        want_cycle = {name: sum(model(i, {}, c)[name] for i, c in enumerate(cutoffs))
                      for name in KERNELS}
        assert cycle_counts == want_cycle, (dtype, cycle_counts, want_cycle)
        rec["cycle_launches"] = cycle_counts
        if dtype == "float32":
            cycle_calls = crec.unique()
            recorded = {n: sum(m for c, m in cycle_calls.items() if c[0] == n) for n in KERNELS}
            assert recorded == cycle_counts, (recorded, cycle_counts)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(GAN_CYCLE):
            metrics, _ = run.run(i)
        float(metrics["g_loss"])
        cycle_s = time.perf_counter() - t0
        rec["cycle_ms"] = cycle_s * 1e3
        rec["cycle_img_per_s"] = GAN_CYCLE * GAN_BATCH / cycle_s
        rec["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        say("gan", f"{dtype} batch {GAN_BATCH}: step median "
            + ", ".join(f"{label} {rec[label]['step_ms_median']:.2f} ms"
                        for label, _, _ in GAN_CADENCES)
            + f" ({GAN_TIMED} steps after {GAN_WARMUP}); the 16-step cycle (1 R1 + path-length "
            f"step, 3 path-length, 12 plain) {rec['cycle_ms']:.1f} ms = "
            f"{rec['cycle_img_per_s']:.1f} img/s, launches {cycle_counts} = expected; peak "
            f"memory {rec['peak_mib']:.0f} MiB; ada_p {GAN_ADA_P}; TF32 cudnn="
            f"{torch.backends.cudnn.allow_tf32}, matmul={torch.backends.cuda.matmul.allow_tf32} "
            f"(PyTorch's defaults); {card}")
        rec["profile"] = {label: profile_gan_step(run, label, i,
                                                  kernels_want(calls[f"gan {dtype} {label}"]), dtype)
                          for label, i, _ in GAN_CADENCES if label in ("r1", "ppl")}
        out[dtype] = rec
        del run
        torch.cuda.empty_cache()
    out["cycle_calls"] = cycle_calls  # tuple keys: main() takes it out before any JSON
    return out, calls


def profile_gan_step(run: GanRun, label: str, i: int, want: dict[str, int], dtype: str) -> dict:
    """Device time by kernel class over one GAN step of a regulariser's
    cadence; a session counts only if it recorded every device kernel of
    the port's wrappers (``want``, from kernels_want)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        run.run(i, label)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            metrics, _ = run.run(i, label)
            float(metrics["g_loss"])
            wall = (time.perf_counter() - t0) * 1e3
        events = kernel_events(prof)
        if all(sum(e.count for e in events if KERNEL_SYMBOLS[name] in e.key) >= n
               for name, n in want.items()):
            break
    else:
        say("profile", f"gan {dtype} {label}: not measured (torch.profiler missed launches in "
            "three sessions)")
        return {"wall_ms": wall, "device_ms": None}
    total = sum(e.self_device_time_total for e in events) / 1e3
    ours = {name: sum(e.self_device_time_total for e in events if KERNEL_SYMBOLS[name] in e.key)
            / 1e3 for name in KERNELS}
    classes: dict[str, list] = {}
    for e in events:
        c = classes.setdefault(classify_kernel(e.key), [0.0, 0])
        c[0] += e.self_device_time_total / 1e3
        c[1] += e.count
    top = [dict(name=e.key, device_ms=e.self_device_time_total / 1e3, count=e.count)
           for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]]
    say("profile", f"gan {dtype} {label} step: wall {wall:.1f} ms, device busy {total:.1f} ms "
        f"({100 * total / wall:.1f}%); " + ", ".join(f"{n} {t:.3f} ms" for n, t in ours.items())
        + "; by class: " + "; ".join(
            f"{cls} {ms:.2f} ms ({100 * ms / total:.1f}%, {n})"
            for cls, (ms, n) in sorted(classes.items(), key=lambda kv: -kv[1][0])))
    for row in top[:5]:
        say("profile", f"gan {dtype} {label} {row['device_ms']:9.3f} ms  x{row['count']:<5} "
            f"{row['name'][:100]}")
    return {"wall_ms": wall, "device_ms": total, "ours_ms": ours, "classes": classes,
            "top": top}


class SameNoise:
    """While active, a draw of torch.randn from a CUDA generator takes its
    numbers from a CPU twin of that generator (seeded alike, advancing
    alike), so the card's synthesis noise is the CPU run's: the
    counterpart, for the GAN step, of the VisCoIN step's injected dropout
    mask."""

    def __enter__(self):
        self._orig = torch.randn
        twins: dict[int, tuple] = {}
        orig = self._orig

        def randn(*size, generator=None, device=None, **kw):
            if generator is not None and generator.device.type == "cuda":
                # Held with the generator, whose id then stays its own.
                _, twin = twins.setdefault(id(generator), (generator, torch.Generator().manual_seed(
                    generator.initial_seed())))
                return orig(*size, generator=twin, **kw).to(device)
            return orig(*size, generator=generator, device=device, **kw)

        torch.randn = randn
        return self

    def __exit__(self, *exc):
        torch.randn = self._orig


class SecondOrderFault:
    """A planted fault, for the control of phase_gan_cpu: while active,
    bias_act's second order (the backward of its backward, the launches R1
    and the path length add) takes the lrelu slope GAN_FAULT_ALPHA where
    the forward and the first order take 0.2."""

    def __enter__(self):
        orig = self._orig = ba._BiasActGrad.backward

        def backward(ctx, g_dx, g_db):
            args = ctx.args
            if args["act"] == "lrelu":
                ctx.args = {**args, "alpha": GAN_FAULT_ALPHA}
            try:
                return orig(ctx, g_dx, g_db)
            finally:
                ctx.args = args

        ba._BiasActGrad.backward = staticmethod(backward)
        return self

    def __exit__(self, *exc):
        ba._BiasActGrad.backward = staticmethod(self._orig)


def r1_alone(dd, real: torch.Tensor, aug_p: float, aug_draws) -> tuple[float, dict]:
    """R1 as ``d_loss_fn`` takes it (the squared gradient of D's logits for
    the real images, through the real pass's augment pipe) and its gradient
    for every D leaf, alone: in the step R1 adds about 1e-4 to a D loss of
    about 1, too little for the step's gradients to show its second order."""
    real = real.detach().requires_grad_(True)
    logits = dd(augment(real, aug_p, aug_draws)).float()
    (grad_real,) = torch.autograd.grad(logits.sum(), real, create_graph=True)
    r1 = grad_real.float().square().sum(dim=(1, 2, 3)).mean()
    names, params = zip(*dd.named_parameters())
    grads = torch.autograd.grad(r1, params, materialize_grads=True)
    return float(r1.detach()), {f"D.{n}": t.detach().cpu() for n, t in zip(names, grads)}


def grad_ratios(got: dict, want: dict) -> dict[str, float]:
    """max |got - want| / max |want| per leaf; a leaf that is exactly zero
    in ``want`` (R1 reaches no bias of D's last layers) must be exactly zero
    in ``got`` (else inf)."""
    out = {}
    for key, w in want.items():
        scale, err = float(w.abs().max()), float((got[key] - w).abs().max())
        out[key] = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
    return out


def phase_gan_cpu(g, d) -> dict:
    """One fp32 GAN step with both regularisers (step 0) at full width on
    GAN_CPU_BATCH images (mbstd group 4, the main path's), on the card and
    on device="cpu", from the same weights (noise strengths 0), draws and
    synthesis noise, TF32 off: losses within 1e-4, R1 and the mean path
    length within 1e-3, every G and D gradient (Adam's first moment,
    beta1 = 0; the noise strengths too) within GAN_GRAD_TOL of its leaf's
    max |grad|. The learning rate is 0, so that the D phase of both devices
    runs the same generator: Adam's first update (lr * g / (|g| + eps))
    turns the last bits of a gradient next to zero into a step of lr, which
    would make the two D phases see different fakes (a first run with lr
    2.5e-3 put D's gradients 5e-2 apart). Then R1's gradients alone
    (r1_alone, on the step's real images and draws), each D leaf within
    GAN_GRAD_TOL; and the control: the card's step and R1 alone again under
    SecondOrderFault, whose R1 gradients must miss GAN_GRAD_TOL."""
    from viscoin_tpu_torch.cli.train import build_gan_modules

    set_tf32(False)
    sd_g = {k: v.cpu() for k, v in g.state_dict().items()}
    sd_d = {k: v.cpu() for k, v in d.state_dict().items()}
    for k in sd_g:
        if k.endswith("noise_strength"):
            sd_g[k] = torch.zeros_like(sd_g[k])
    cfg = TG.GANTrainingParams(compute_dtype="float32", augment_p=GAN_ADA_P,
                               batch_size=GAN_CPU_BATCH, learning_rate=0.0)
    images = torch.from_numpy(seeded_images(GAN_CPU_BATCH, GAN_SEED + 6))
    out = {}
    t0 = time.perf_counter()
    for device, fault in (("cpu", False), ("cuda", False), ("cuda", True)):
        gg, dd = build_gan_modules(RES, CHANNEL_BASE, CHANNEL_MAX, GAN_CPU_BATCH, device=device,
                                   seed=GAN_SEED)
        gg.load_state_dict(sd_g)
        dd.load_state_dict(sd_d)
        state = TG.create_gan_train_state(gg, dd, cfg)
        draws = TG.draw_step(cfg, gg, GAN_SEED, 0, "cpu").to(device)
        real = TG.preprocess_real(images.to(device), draws.flips if cfg.mirror else None)
        _kernels.reset_launch_counts()
        with SameNoise(), (SecondOrderFault() if fault else contextlib.nullcontext()):
            r1, r1_grads = r1_alone(dd, real, cfg.augment_p, draws.aug_dr)
            _, m = TG.make_gan_train_step(gg, dd, cfg)(state, images.to(device), draws)
        grads = {f"{who}.{n}": opt.state[p]["exp_avg"].cpu()
                 for who, module, opt in (("G", gg, state.g_opt), ("D", dd, state.d_opt))
                 for n, p in module.named_parameters()}
        out[device, fault] = dict(metrics={k: float(v) for k, v in m.items()}, grads=grads,
                                  r1=r1, r1_grads=r1_grads, launches=_kernels.launch_counts(),
                                  s=time.perf_counter() - t0)
        del gg, dd, state
    cpu, card, bad = out["cpu", False], out["cuda", False], out["cuda", True]
    rel = {k: abs(card["metrics"][k] - cpu["metrics"][k]) / abs(cpu["metrics"][k])
           for k in ("g_loss", "d_loss", "r1", "pl_lengths")}
    rel["r1_alone"] = abs(card["r1"] - cpu["r1"]) / cpu["r1"]
    ratios = grad_ratios(card["grads"], cpu["grads"])
    assert all(float(t.abs().max()) > 0 for t in cpu["grads"].values()), "a zero CPU gradient"
    assert all(float(t.abs().max()) > 0 for t in card["grads"].values()), "a zero card gradient"
    r1_ratios = grad_ratios(card["r1_grads"], cpu["r1_grads"])
    bad_ratios = grad_ratios(bad["grads"], cpu["grads"])
    bad_r1 = grad_ratios(bad["r1_grads"], cpu["r1_grads"])
    live = [k for k, t in cpu["r1_grads"].items() if float(t.abs().max()) > 0]
    noise = {k for k in ratios if k.endswith("noise_strength")}

    def worst(r: dict, keys) -> str:
        return max(keys, key=r.get)

    w, wn, wr = worst(ratios, set(ratios) - noise), worst(ratios, noise), worst(r1_ratios, live)
    bw, bwn, bwr = worst(bad_ratios, set(ratios) - noise), worst(bad_ratios, noise), worst(bad_r1,
                                                                                          live)
    say("gan-cpu", f"one fp32 GAN step with R1 and the path length at full width, "
        f"{GAN_CPU_BATCH} images (mbstd group {GAN_CPU_BATCH}), TF32 off, learning rate 0, noise "
        f"strengths 0, the same draws and noise: relative card-vs-CPU differences "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
        + f" (card r1 {card['metrics']['r1']:.6g}, pl_lengths "
        f"{card['metrics']['pl_lengths']:.6f}); {len(ratios)} G and D gradients, max |card - CPU|"
        f" / leaf max |grad|: worst tensor {w} {ratios[w]:.3e}, median "
        f"{statistics.median(ratios.values()):.3e}, worst of the {len(noise)} noise strengths "
        f"{wn} {ratios[wn]:.3e}; R1 alone (r1 {card['r1']:.6g}), its gradients for the "
        f"{len(live)} D leaves it reaches: worst {wr} {r1_ratios[wr]:.3e}, median "
        f"{statistics.median(r1_ratios[k] for k in live):.3e}, the other "
        f"{len(r1_ratios) - len(live)} exactly zero on both (tolerance {GAN_GRAD_TOL:g} for "
        f"all); launches on the card {card['launches']}; CPU step and R1 {cpu['s']:.1f} s")
    say("gan-cpu", f"control, the card under SecondOrderFault (the second order's lrelu slope "
        f"{GAN_FAULT_ALPHA}, not 0.2) against the same CPU run: R1 alone's gradients worst "
        f"{bwr} {bad_r1[bwr]:.3e}, median {statistics.median(bad_r1[k] for k in live):.3e}; the "
        f"step's worst tensor {bw} {bad_ratios[bw]:.3e}, worst noise strength {bwn} "
        f"{bad_ratios[bwn]:.3e}; r1 {bad['metrics']['r1']:.6g}, pl_lengths "
        f"{bad['metrics']['pl_lengths']:.6f} (tolerance {GAN_GRAD_TOL:g}: R1's must miss it)")
    assert set(cpu["launches"].values()) == {0} and min(card["launches"].values()) > 0, (
        card["launches"], cpu["launches"])
    assert cpu["metrics"]["r1"] > 0 and cpu["metrics"]["pl_lengths"] > 0, cpu["metrics"]
    assert rel["g_loss"] <= 1e-4 and rel["d_loss"] <= 1e-4, rel
    assert rel["r1"] <= 1e-3 and rel["pl_lengths"] <= 1e-3 and rel["r1_alone"] <= 1e-3, rel
    assert ratios[w] <= GAN_GRAD_TOL, (w, ratios[w])
    assert ratios[wn] <= GAN_GRAD_TOL, (wn, ratios[wn])
    assert live and r1_ratios[worst(r1_ratios, r1_ratios)] <= GAN_GRAD_TOL, r1_ratios
    assert bad_r1[bwr] > GAN_GRAD_TOL, ("the control passed", bwr, bad_r1[bwr])
    return {"metrics_card": card["metrics"], "metrics_cpu": cpu["metrics"], "rel": rel,
            "grad_rel_err": ratios, "r1_grad_rel_err": r1_ratios,
            "control_grad_rel_err": bad_ratios, "control_r1_grad_rel_err": bad_r1,
            "card_launches": card["launches"], "cpu_s": cpu["s"]}


def gan_cli_command(args: list[str]) -> list[str]:
    """`python -m viscoin_tpu_torch <args>` as runpy runs it, with cuDNN's
    deterministic algorithms on (the resume comparison's condition)."""
    code = ("import runpy, sys, torch\n"
            "torch.backends.cudnn.deterministic = True\n"
            "torch.backends.cudnn.benchmark = False\n"
            f"sys.argv = ['viscoin_tpu_torch'] + {args!r}\n"
            "runpy.run_module('viscoin_tpu_torch', run_name='__main__', alter_sys=True)\n")
    return [sys.executable, "-c", code]


def phase_gan_cli(card: str) -> dict:
    """`python -m viscoin_tpu_torch train gan` at 256² on the card, on 32
    synthetic images in a temporary directory, under cuDNN deterministic: 4
    iterations (checkpoint and snapshot every 2), a resume to 6, and beside
    both an unbroken run to 6; the resumed state within RESUME_RTOL of the unbroken
    one in every tensor; beside the resume, `train viscoin --dataset
    synthetic` for one iteration in a directory holding a copy of the first
    run's export, which it must load."""
    tmp = tempfile.mkdtemp(prefix="viscoin_gan_cli_")
    repo = str(Path(__file__).resolve().parent)
    env = {k: v for k, v in os.environ.items() if k != "VISCOIN_SYNTH_SIZE"}
    env.update(VISCOIN_SYNTH_N="32", PYTHONPATH=repo + os.pathsep + env.get("PYTHONPATH", ""))
    export = "checkpoints/synthetic/gan-synthetic"
    base = ["train", "gan", "--dataset", "synthetic", "--checkpoint-every", "2",
            "--snapshot-every", "2"]
    out = {}

    def run(label, args, cwd):
        t0 = time.perf_counter()
        res = subprocess.run(gan_cli_command(args), cwd=cwd, env=env, capture_output=True,
                             text=True, timeout=600)
        out[f"{label}_s"] = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(f"`{' '.join(args[:2])}` ({label}) exited {res.returncode}:\n"
                               f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
        return res.stdout

    pool = ThreadPoolExecutor(2)
    try:
        unbroken = os.path.join(tmp, "unbroken")
        os.makedirs(unbroken)
        # The unbroken run depends on nothing here: it runs beside the first
        # run and the resume (both processes on the card at once).
        beside = pool.submit(run, "unbroken", base + ["--epochs", "6", "--output-weights",
                                                      export], unbroken)
        run("first", base + ["--epochs", "4", "--output-weights", export], tmp)
        files = set(os.listdir(tmp))
        assert {"gan_4.jsonl", "fakes_000000.png", "fakes_000002.png",
                "fakes_000003.png"} <= files, files
        recs = read_jsonl(os.path.join(tmp, "gan_4.jsonl"))
        assert [r["iteration"] for r in recs] == [0, 3], recs
        assert recs[0]["r1"] > 0 and recs[0]["pl_lengths"] > 0, recs[0]
        assert all(math.isfinite(v) for r in recs for v in r.values()), recs
        # The first run's export, for train viscoin beside the resume (which
        # writes the export again when it ends).
        vdir = os.path.join(tmp, "viscoin")
        shutil.copytree(os.path.join(tmp, export), os.path.join(vdir, export))
        viscoin = pool.submit(run, "viscoin", [
            "train", "viscoin", "--dataset", "synthetic", "--epochs", "1", "--batch-size", "8",
            "--eval-every", "0", "--checkpoint-every", "0", "--faithfulness-every", "0"], vdir)
        run("resume", base + ["--epochs", "6", "--resume", f"{export}.train_state",
                              "--output-weights", export], tmp)
        beside.result()
        states = [torch.load(os.path.join(d, f"{export}.train_state", "train_state.pt"),
                             weights_only=True) for d in (tmp, unbroken)]
        assert states[0]["step"] == states[1]["step"] == 6
        dev = tree_deviation(*states)
        worst = max(dev, key=dev.get)
        out["resume_deviation"] = dev
        differ = sum(1 for v in dev.values() if v > 0)
        say("gan-cli", f"python -m viscoin_tpu_torch train gan --dataset synthetic at 256², 32 "
            f"images, batch 16, cuDNN deterministic: 4 iterations (checkpoint and snapshot "
            f"every 2) {out['first_s']:.1f} s, 2 jsonl records (i = 0: r1 {recs[0]['r1']:.4f}, "
            f"pl_lengths {recs[0]['pl_lengths']:.4f}), snapshots fakes_000000/2/3.png; resume "
            f"to 6 {out['resume_s']:.1f} s; unbroken run to 6 {out['unbroken_s']:.1f} s (beside "
            f"the first two on the card: walls under contention, not comparable with runs made "
            f"one after another); "
            f"resumed against unbroken, largest relative deviation {dev[worst]:.3e} ({worst}; "
            f"{differ} of {len(dev)} tensors not bit-equal; tolerance {RESUME_RTOL:g}); {card}")
        assert dev[worst] <= RESUME_RTOL, ("the resumed GAN run deviates", worst, dev[worst])
        log = viscoin.result()
        assert "RANDOM generator" not in log, log[-2000:]
        say("gan-cli", f"python -m viscoin_tpu_torch train viscoin --dataset synthetic, 1 "
            f"iteration, beside the resume (walls under contention), in a directory holding a "
            f"copy of the first run's export: loaded the exported EMA generator from {export} "
            f"(no RANDOM-generator warning), {out['viscoin_s']:.1f} s; {card}")
        return out
    finally:
        pool.shutdown(wait=True)
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------- weights, FID, the classifier ----------------------- #

# The three phases share one directory, laid out as a user's: the ported
# checkpoints at the paths the commands read.
PIPE_N = 64  # synthetic images per split for the pipeline's commands
FID_SAMPLES, FID_BATCH = 64, GAN_BATCH
CPU_FEATURE_TOL = 1e-2  # Inception features, card (TF32 defaults) vs CPU, of the features' scale
FID_RECOMPUTE_RTOL = 1e-4
CLS_CPU_BATCH, CLS_BATCH = 8, 32
# The classifier step card vs CPU. In float64: loss, every gradient (of the
# leaf's scale) and the running statistics. In fp32 the loss and the running
# statistics; the fp32 gradients of this random, train-mode-BN ResNet-50 are
# not held: on the CPU alone they are 2e-2 (median) and up to 0.19 of their
# leaf's scale from its float64 gradients (the same at 128² and batch 32, with
# a fast or a two-pass variance), an fp32 spread the card cannot beat.
CLS_LOSS_RTOL, CLS_STATS_TOL = 1e-5, 1e-4
CLS_F64_TOL = (1e-10, 1e-6, 1e-10)  # loss, gradients, running statistics (float64)


def _torch_sd(sd: dict) -> dict:
    return {k: torch.as_tensor(np.asarray(v)).clone() for k, v in sd.items()}


def lpips_state_dict(params: dict) -> dict:
    """The pip-lpips state_dict of LPIPS params (JAX layout): the inverse of
    ``convert_torch_lpips``, to build a source in the reference's layout."""
    sd = {}
    convs = [(s, li) for s, layers in porting._LPIPS_SLICES.items() for li in layers]
    for k, (s, li) in enumerate(convs):
        sd[f"net.slice{s}.{li}.weight"] = exporting._conv_back(params["vgg"][f"conv{k}"]["kernel"])
        sd[f"net.slice{s}.{li}.bias"] = np.asarray(params["vgg"][f"conv{k}"]["bias"])
    for i in range(5):
        sd[f"lin{i}.model.1.weight"] = np.asarray(params[f"lin{i}"]).reshape(1, -1, 1, 1)
    return sd


def _reconstruct_persistent_obj(meta):  # what NVlabs pickles name, by reference
    return meta


_reconstruct_persistent_obj.__module__ = "torch_utils.persistence"


class _Persisted:
    """Pickles as torch_utils.persistence._reconstruct_persistent_obj(meta),
    as NVlabs' persistent modules do."""

    def __init__(self, meta):
        self.meta = meta

    def __reduce__(self):
        import torch_utils.persistence as pers

        return pers._reconstruct_persistent_obj, (self.meta,)


def fabricate_nvlabs_pickle(path: str, g_sd: dict, d_sd: dict) -> None:
    """{'G_ema', 'G', 'D'} in NVlabs' persistence layout (children under
    ``_modules``, tensors under ``_parameters``/``_buffers``), written with a
    ``torch_utils`` that exists only for the write."""
    import pickle
    import types

    buffers = ("w_avg", "noise_const", "resample_filter")

    def meta(sd: dict) -> dict:
        root: dict = {}
        for key, value in sd.items():
            node = root
            *parts, leaf = key.split(".")
            for part in parts:
                node = node.setdefault(part, {})
            node[leaf] = value

        def build(node):
            state = {"training": False,
                     "_parameters": {k: torch.as_tensor(v) for k, v in node.items()
                                     if not isinstance(v, dict) and k not in buffers},
                     "_buffers": {k: torch.as_tensor(v) for k, v in node.items()
                                  if not isinstance(v, dict) and k in buffers},
                     "_modules": {k: _Persisted(build(v)) for k, v in node.items()
                                  if isinstance(v, dict)}}
            return {"type": "class", "version": 3, "module_src": "# source elided",
                    "class_name": "Module", "state": state}

        return build(root)

    pers = types.ModuleType("torch_utils.persistence")
    pers._reconstruct_persistent_obj = _reconstruct_persistent_obj
    tu = types.ModuleType("torch_utils")
    tu.persistence = pers
    sys.modules["torch_utils"], sys.modules["torch_utils.persistence"] = tu, pers
    try:
        g = _Persisted(meta(g_sd))
        with open(path, "wb") as f:
            pickle.dump({"G_ema": g, "G": g, "D": _Persisted(meta(d_sd))}, f)
    finally:
        del sys.modules["torch_utils"], sys.modules["torch_utils.persistence"]


def assert_trees_equal(a, b, path: str = "") -> None:
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(set(a) ^ set(b))[:5])
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), path


def _port_main(argv: list[str]) -> int:
    """``python -m viscoin_tpu_torch <argv>`` in this process; the exit code."""
    from viscoin_tpu_torch.__main__ import main

    try:
        return main(argv)
    except SystemExit as done:
        return int(done.code or 0)


def pipe_env() -> dict:
    repo = str(Path(__file__).resolve().parent)
    env = {k: v for k, v in os.environ.items() if k != "VISCOIN_SYNTH_SIZE"}
    env.update(VISCOIN_SYNTH_N=str(PIPE_N), PYTHONPATH=repo + os.pathsep + env.get("PYTHONPATH",
                                                                                     ""))
    return env


def run_command(label: str, args: list[str], cwd: str, out: dict, deterministic=False) -> str:
    """``python -m viscoin_tpu_torch <args>`` in a process of its own; its
    standard output. Raises on a non-zero exit."""
    cmd = gan_cli_command(args) if deterministic else [sys.executable, "-m",
                                                       "viscoin_tpu_torch", *args]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=cwd, env=pipe_env(), capture_output=True, text=True,
                         timeout=900)
    out[f"{label}_s"] = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"`{' '.join(args[:2])}` ({label}) exited {res.returncode}:\n"
                           f"{res.stdout[-3000:]}\n{res.stderr[-4000:]}")
    return res.stdout


def phase_port(work: str, card: str) -> dict:
    """Seeded sources in the reference's layouts at the manifests' full
    shapes (ResNet-50 classifiers with 200 and with 10 classes, LPIPS-VGG,
    pytorch-fid Inception, the 256² NVlabs generator and discriminator in a
    fabricated network pickle), each held against its manifest; `port-weights`
    on each (loading it on the card) to the commands' default paths; `--check`
    on a mis-shaped copy must exit 1; each result loaded onto the card, then
    exported and imported again, bit-equal to the source and to the port."""
    from viscoin_tpu_torch.cli import port_weights as pw
    from viscoin_tpu_torch.cli.train import build_gan_modules
    from viscoin_tpu_torch.models.inception import InceptionV3Features, inception_from_tree
    from viscoin_tpu_torch.models.resnet import Classifier

    t_start = time.perf_counter()
    src = os.path.join(work, "sources")
    os.makedirs(src)
    out: dict = {"ported": {}}
    sources: dict = {}
    for n in (200, 10):
        m = init_models(Classifier(output_classes=n, device="cuda"), SEED + 90 + n)
        perturb_constants(m, SEED + 91 + n)
        sources[f"classifier{n}"] = exporting.export_classifier_torch(module_to_jax_tree(m))
    lp = init_models(LPIPS(device="cuda"), SEED + 93)
    perturb_constants(lp, SEED + 94)
    sources["lpips"] = lpips_state_dict(module_to_jax_tree(lp)["params"])
    inc = InceptionV3Features(device="cuda")
    with torch.no_grad():
        gen = torch.Generator(device="cuda").manual_seed(SEED + 95)
        for mod in inc.modules():
            if isinstance(mod, torch.nn.Conv2d):  # He-normal: the features keep the signal
                mod.weight.normal_(0.0, math.sqrt(2.0 / mod.weight[0].numel()), generator=gen)
            elif isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.uniform_(-0.2, 0.2, generator=gen)
                mod.running_var.uniform_(0.5, 1.5, generator=gen)
                mod.weight.uniform_(0.5, 1.5, generator=gen)
                mod.bias.uniform_(-0.2, 0.2, generator=gen)
    sources["inception"] = porting.state_dict_to_numpy(inc.state_dict())
    g, d = build_gan_modules(RES, CHANNEL_BASE, CHANNEL_MAX, GAN_BATCH, device="cuda",
                             seed=SEED + 96)
    perturb_constants(g, SEED + 97)
    perturb_constants(d, SEED + 98)
    sources["G"] = exporting.export_generator_torch(module_to_jax_tree(g))
    sources["D"] = exporting.export_discriminator_torch(module_to_jax_tree(d)["params"])
    del m, lp, inc, g, d
    manifests = {"classifier200": "classifier", "classifier10": "classifier",
                 "lpips": "lpips", "inception": "inception", "G": "stylegan_generator"}
    for key, kind in manifests.items():
        problems = porting.validate_state_dict(sources[key], kind, strict=False)
        assert not problems, (key, problems[:5])
    files = {}
    for key in ("classifier200", "classifier10", "lpips", "inception"):
        files[key] = os.path.join(src, f"{key}.pth")
        torch.save(_torch_sd(sources[key]), files[key])
    files["stylegan"] = os.path.join(src, "network-snapshot.pkl")
    fabricate_nvlabs_pickle(files["stylegan"], sources["G"], sources["D"])
    out["source_params_m"] = {k: sum(np.asarray(v).size for v in sd.values()) / 1e6
                              for k, sd in sources.items()}

    dst = {"classifier200": "checkpoints/cub/classifier-cub",
           "classifier10": "checkpoints/synthetic/classifier-synthetic",
           "lpips": "checkpoints/lpips-vgg", "inception": "checkpoints/inception",
           "stylegan": "checkpoints/synthetic/gan-synthetic"}
    cwd = os.getcwd()
    os.chdir(work)
    try:
        for key, path in dst.items():
            kind = "classifier" if key.startswith("classifier") else key
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as log:
                code = _port_main(["port-weights", kind, files[key], path, "--strict"])
            assert code == 0, (key, code, log.getvalue()[-2000:])
            assert "OK" in log.getvalue(), log.getvalue()[-1000:]
            out["ported"][key] = time.perf_counter() - t0
        bad = os.path.join(src, "misshaped.pth")
        mis = dict(sources["classifier10"])
        mis_key = "resnet.encoder.stages.1.layers.0.layer.1.convolution.weight"
        mis[mis_key] = mis[mis_key][:, :, :2]
        torch.save(_torch_sd(mis), bad)
        with contextlib.redirect_stdout(io.StringIO()) as log:
            codes = (_port_main(["port-weights", "classifier", files["classifier10"], "--check"]),
                     _port_main(["port-weights", "classifier", bad, "--check"]))
        assert codes == (0, 1), (codes, log.getvalue()[-2000:])
        assert f"shape mismatch: {mis_key}" in log.getvalue()

        # Each result on the card, then out to the reference's layout and
        # back in: bit-equal to the source and to what was written.
        for key in ("classifier200", "classifier10"):
            tree = ckpt.restore_pytree(dst[key])
            model = pw.classifier_from_tree(tree, "cuda")
            sd = exporting.export_classifier_torch(module_to_jax_tree(model))
            assert_trees_equal(sd, sources[key], key)
            assert_trees_equal(porting.convert_torch_classifier(sd), tree, key)
        tree = ckpt.restore_pytree(dst["lpips"])
        lp = load_jax_tree(LPIPS(device="cuda"), {"params": tree})
        assert_trees_equal(lpips_state_dict(module_to_jax_tree(lp)["params"]), sources["lpips"])
        assert_trees_equal(module_to_jax_tree(lp)["params"], tree, "lpips")
        tree = ckpt.restore_pytree(dst["inception"])
        inc = inception_from_tree(tree, "cuda")
        assert_trees_equal(porting.convert_torch_inception(porting.state_dict_to_numpy(
            inc.state_dict())), tree, "inception")
        assert_trees_equal(module_to_jax_tree(inc), tree, "inception")
        tree = ckpt.restore_pytree(dst["stylegan"])
        g = pw.generator_from_tree(tree, "cuda")
        sd = exporting.export_generator_torch(module_to_jax_tree(g))
        assert_trees_equal(sd, sources["G"], "G")
        assert_trees_equal(porting.convert_torch_generator(sd), tree, "G")
        d_tree = ckpt.restore_pytree(dst["stylegan"] + ".discriminator")
        d = pw.discriminator_from_tree(d_tree, "cuda")
        sd = exporting.export_discriminator_torch(module_to_jax_tree(d)["params"])
        assert_trees_equal(sd, sources["D"], "D")
        assert_trees_equal(porting.convert_torch_discriminator(sd), d_tree, "D")
    finally:
        os.chdir(cwd)
    out["seconds"] = time.perf_counter() - t_start
    say("port", f"sources at the manifests' full shapes ("
        + ", ".join(f"{k} {v:.1f} M" for k, v in out["source_params_m"].items())
        + " values), each clean against its manifest; port-weights --strict on each, loaded "
        "on the card: " + ", ".join(f"{k} {v:.1f} s" for k, v in out["ported"].items())
        + f"; --check exits 0 on the clean classifier and 1 on a mis-shaped copy ({mis_key}); "
        "every "
        "result loaded on the card, exported and converted again: bit-equal to its source and "
        f"to what port-weights wrote; the phase took {out['seconds']:.1f} s (beside the mp "
        f"processes' start); {card}")
    return out


class NvlabsStyleDetector(torch.nn.Module):
    """A detector in the NVlabs convention, as the TorchScript file is
    built: its own bilinear resize to 299², (x - 128) / 128, then the
    Inception network (whose parameters trace in the TF graph's order)."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x):
        if x.shape[2] != 299 or x.shape[3] != 299:
            x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False)
        return self.net((x - 128.0) / 128.0)


def _rel_dev(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float().cpu() - want.float().cpu()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def phase_fid(work: str, device: dict) -> tuple[dict, dict]:
    """Inception on the card against the card's host CPU (TF32 at
    PyTorch's defaults); the NVlabs route (a traced full-width detector,
    ported, the two compared on the card); `train gan --fid-every 2
    --fid-samples 64` at 256², full width, 3 iterations (one estimate),
    under cuDNN deterministic, its FID against a recomputation from its
    export with the same draws; `train viscoin --fid-detector` reading the
    ported classifier, GAN and LPIPS from the default paths, one eval; the
    FID sampling's launches (one estimate: 4 batches of 16) against the
    CPU's count, its kernel calls recorded; an Inception batch and a whole
    FID estimate (the recomputation) timed. The two commands run at once.
    Returns (record, the FID sampling's kernel calls)."""
    from viscoin_tpu_torch.cli import port_weights as pw
    from viscoin_tpu_torch.cli.train import _load_fid_detector
    from viscoin_tpu_torch.models import inception as tinc

    card = device["nvidia_smi"]
    out: dict = {}
    tf32_defaults(device)
    det_dir = os.path.join(work, "checkpoints/inception")
    tree = ckpt.restore_pytree(det_dir)
    detect = tinc.make_fid_detector(tree, "cuda")
    x = torch.from_numpy(seeded_images(8, SEED + 100)).cuda()
    x = device_preprocess(x)
    feats = detect(x)
    cpu_feats = tinc.make_fid_detector(tree, "cpu")(x.cpu())
    out["card_vs_cpu"] = _rel_dev(feats, cpu_feats)
    assert torch.isfinite(feats).all() and feats.shape == (8, 2048)
    assert out["card_vs_cpu"] <= CPU_FEATURE_TOL, out["card_vs_cpu"]
    say("fid", f"Inception features of 8 images at 256² (resized to 299²), ported pytorch-fid "
        f"weights: card (TF32 at PyTorch's defaults: cudnn {torch.backends.cudnn.allow_tf32}) "
        f"against the host CPU, max |card - CPU| / max |CPU| = {out['card_vs_cpu']:.3e} "
        f"(tolerance {CPU_FEATURE_TOL:g})")

    # The NVlabs route: a traced detector in that convention, ported.
    ts_path = os.path.join(work, "sources", "inception-nvlabs-style.pt")
    with torch.no_grad():
        net = tinc.inception_from_tree(tree, "cuda")
        torch.jit.trace(NvlabsStyleDetector(net).eval(),
                        torch.zeros(1, 3, 256, 256, device="cuda")).save(ts_path)
    nv_dir = os.path.join(work, "checkpoints/inception-nvlabs")
    with contextlib.redirect_stdout(io.StringIO()) as log:
        code = _port_main(["port-weights", "inception-nvlabs", ts_path, nv_dir])
    assert code == 0, log.getvalue()[-2000:]
    ts_detect = tinc.make_torchscript_fid_detector(ts_path, "cuda")
    nv_detect = _load_fid_detector(nv_dir, torch.device("cuda"))
    x299 = torch.rand(8, 3, 299, 299, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(SEED + 101)) * 4.7 - 2.1
    out["nvlabs_299"] = _rel_dev(nv_detect(x299), ts_detect(x299))
    out["nvlabs_256"] = _rel_dev(nv_detect(x), ts_detect(x))
    assert out["nvlabs_299"] <= pw.NVLABS_TOL, out["nvlabs_299"]
    say("fid", f"inception-nvlabs: a full-width detector in the NVlabs convention traced on the "
        f"card and ported ({log.getvalue().strip().splitlines()[-2]}); the ported detector "
        f"against the TorchScript one on the card, 8 images: {out['nvlabs_299']:.3e} at 299² "
        f"(tolerance {pw.NVLABS_TOL:g}), {out['nvlabs_256']:.3e} at 256² (the export's own "
        "half-pixel resize against the TF1 convention, not held)")

    # train gan --fid-every, then the same FID from the export; beside it,
    # train viscoin on the ported pieces with the FID detector, one eval.
    viscoin_args = ["train", "viscoin", "--dataset", "synthetic", "--epochs", "2",
                    "--batch-size", str(BATCH), "--eval-every", "2", "--checkpoint-every", "0",
                    "--faithfulness-every", "0", "--fid-detector", "checkpoints/inception"]
    pool = ThreadPoolExecutor(1)
    try:
        viscoin_run = pool.submit(run_command, "train_viscoin_fid", viscoin_args, work, out)
        launches, calls, g = _fid_commands(work, out, detect, card)
        viscoin_log = viscoin_run.result()
    finally:
        pool.shutdown(wait=True)
    out["launches"] = launches
    assert "RANDOM" not in viscoin_log, viscoin_log[-3000:]
    evals = [r for r in read_jsonl(os.path.join(work, "viscoin_2.jsonl"))
             if "test_fid_score" in r]
    assert len(evals) == 1 and math.isfinite(evals[0]["test_fid_score"]), evals
    out["viscoin_fid_score"] = evals[0]["test_fid_score"]
    say("port", f"python -m viscoin_tpu_torch {' '.join(viscoin_args)} at 256², full width, in "
        "the directory the port phase filled, beside train gan --fid-every (walls under "
        "contention): it read the ported classifier, GAN and LPIPS from the default paths (no "
        f"RANDOM warning), {out['train_viscoin_fid_s']:.1f} s")
    say("fid", f"the same train viscoin run's eval with --fid-detector checkpoints/inception: "
        f"fid_score {out['viscoin_fid_score']:.4f}, finite; {card}")

    # Timings: an Inception batch of 64; the whole estimate is the
    # recomputation's.
    batch64 = device_preprocess(torch.from_numpy(seeded_images(64, SEED + 102)).cuda())
    out["inception_batch_ms"] = cuda_ms(lambda: detect(batch64), iters=5, warmup=2)
    say("fid", f"an Inception batch of 64 at 256² (resize to 299² included): "
        f"{out['inception_batch_ms']:.2f} ms on the card (events, mean of 5); the "
        f"recomputation above, a whole FID estimate of {FID_SAMPLES} fakes against cached real "
        f"statistics: {out['fid_recompute_ms']:.1f} ms on the host clock (under the call "
        "recorder and cuDNN's deterministic algorithms, beside the train viscoin command), of "
        f"which the 2048² matrix square root on the host {out['fid_sqrtm_ms']:.1f} ms; the "
        f"real side ({FID_SAMPLES} images, loader included) {1e3 * out['real_stats_s']:.1f} "
        f"ms; {card}")
    del g, detect, ts_detect, nv_detect, net
    torch.cuda.empty_cache()
    return out, calls


def _fid_commands(work: str, out: dict, detect, card: str):
    """`train gan --fid-every` in ``work`` (3 iterations, one estimate), its
    FID against a recomputation here from its export with the same draws,
    and the FID sampling's launches against the CPU's count. Returns
    (launches, the sampling's kernel calls, the exported generator)."""
    from viscoin_tpu_torch.cli import port_weights as pw
    from viscoin_tpu_torch.cli.train import _FID_TAG
    from viscoin_tpu_torch.eval.fid import fid_from_stats

    export = "checkpoints/synthetic/gan-fid"
    # 3 iterations: the cadence (every 2, i > 0) and the last iteration both
    # fall on i = 2, so the run makes one estimate.
    args = ["train", "gan", "--dataset", "synthetic", "--epochs", "3", "--fid-every", "2",
            "--fid-samples", str(FID_SAMPLES), "--fid-detector", "checkpoints/inception",
            "--checkpoint-every", "0", "--output-weights", export]
    log = run_command("train_gan_fid", args, work, out, deterministic=True)
    recs = [r for r in read_jsonl(os.path.join(work, "gan_3.jsonl")) if "fid" in r]
    assert [r["iteration"] for r in recs] == [2], recs
    assert all(math.isfinite(r["fid"]) for r in recs), recs
    torch.backends.cudnn.deterministic = True
    try:
        g = pw.generator_from_tree(ckpt.restore_pytree(os.path.join(work, export)), "cuda").eval()
        fake_fn, real_fn = TG.make_gan_fid_fns(FID_BATCH)
        train_ds = SyntheticDataset(n=PIPE_N, image_size=RES, mode="train", transform="gan")
        t0 = time.perf_counter()
        real = TG.accumulate_real_fid_stats(detect, real_fn, train_ds, FID_BATCH, FID_SAMPLES,
                                            device="cuda")
        out["real_stats_s"] = time.perf_counter() - t0
        # The recomputation is a whole estimate against cached real
        # statistics, timed on the host clock as fid_recompute_ms (under the
        # call recorder and cuDNN's deterministic algorithms, so not a
        # free-standing estimate).
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with PathRecorder() as rec:
            fake = TG.accumulate_fake_fid_stats(detect, fake_fn, g, fold_seed(SEED, _FID_TAG, 2),
                                                FID_SAMPLES)
        launches = _kernels.launch_counts()
        t1 = time.perf_counter()
        fid = fid_from_stats(real, fake)
        out["fid_recompute_ms"] = (time.perf_counter() - t0) * 1e3
        out["fid_sqrtm_ms"] = (time.perf_counter() - t1) * 1e3
    finally:
        torch.backends.cudnn.deterministic = False
    out["fid_logged"], out["fid_recomputed"] = recs[-1]["fid"], fid
    rel = abs(fid - recs[-1]["fid"]) / abs(recs[-1]["fid"])
    assert rel <= FID_RECOMPUTE_RTOL, (fid, recs)
    say("fid", f"python -m viscoin_tpu_torch {' '.join(args)} at 256², full width, {PIPE_N} "
        f"images, cuDNN deterministic, beside train viscoin --fid-detector (walls under "
        f"contention): {out['train_gan_fid_s']:.1f} s; the FID record at i = 2 "
        f"({recs[-1]['fid']:.4f}), finite; recomputed here from "
        f"the exported EMA generator with the draws of i = 2: {fid:.4f} (relative difference "
        f"{rel:.3e}, tolerance {FID_RECOMPUTE_RTOL:g}); {card}")

    # The FID sampling's launches: the card's count against the CPU's.
    fake_batches = -(-FID_SAMPLES // FID_BATCH)
    narrow = init_models(Generator(z_dim=8, w_dim=8, img_resolution=RES, channel_base=256,
                                   channel_max=8, mapping_layers=2, device="cpu"), 1).eval()
    per_batch = count_plain_calls(lambda: TG.make_gan_fid_fns(FID_BATCH)[0](narrow, 1))
    want = {k: v * fake_batches for k, v in per_batch.items()}
    assert launches == want, (launches, want)
    calls = rec.unique()
    assert {n: sum(m for c, m in calls.items() if c[0] == n) for n in KERNELS} == launches
    say("fid", f"one FID estimate ({FID_SAMPLES} fakes, {fake_batches} EMA-generator batches "
        f"of {FID_BATCH} at 256², no_grad): launches {launches} = the same sampling's plain "
        f"calls on the CPU at narrow widths x {fake_batches} ({len(calls)} distinct calls)")
    return launches, calls, g


def _grad_ratios(got: dict, want: dict) -> dict[str, float]:
    return {k: float((got[k].double().cpu() - want[k].double()).abs().max()
                     / want[k].double().abs().max().clamp_min(1e-30)) for k in want}


def phase_classifier(work: str, device: dict) -> dict:
    """The classifier stage at full width (ResNet-50, 200 classes, 256²):
    one fp32 train step card against the host CPU (TF32 off, the same
    flips); the step's time at batch 32 in fp32 and bf16; `train classifier`
    from the ported classifier, then `test classifier` on its output, which
    then loads as `train viscoin` loads its classifier."""
    from viscoin_tpu_torch.cli import port_weights as pw
    from viscoin_tpu_torch.models.resnet import Classifier
    from viscoin_tpu_torch.train import classifiers as TC

    card = device["nvidia_smi"]
    out: dict = {}
    tree = ckpt.restore_pytree(os.path.join(work, "checkpoints/cub/classifier-cub"))
    set_tf32(False)
    model = pw.classifier_from_tree(tree, "cuda")
    rng = np.random.default_rng(SEED + 110)
    images = torch.from_numpy(seeded_images(CLS_CPU_BATCH, SEED + 111))
    labels = torch.from_numpy(rng.integers(0, N_CLASSES, CLS_CPU_BATCH))
    flips = TC.draw_flips(SEED, 0, CLS_CPU_BATCH, "cpu")

    # The float64 twin takes one preprocessed input: the card's fp32 divide by
    # 255 (a product with the reciprocal) is an ulp off the CPU's in places,
    # and this step amplifies an input change by ~1e6 in its gradients.
    x64 = device_preprocess(images, flips).double()

    def step_grads(dev: str, dtype: torch.dtype):
        """The step's loss (classifier_loss in fp32; its float64 twin on one
        preprocessed input), every gradient and the running statistics after
        the forward."""
        m = copy.deepcopy(model).to(dev, dtype)
        params = dict(m.named_parameters())
        if dtype == torch.float32:
            loss, _ = TC.classifier_loss(m, images.to(dev), labels.to(dev), flips.to(dev))
        else:
            logits, _ = m(x64.to(dev), train=True)
            loss = F.cross_entropy(logits, labels.to(dev))
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        stats = {k: v.detach().double().cpu() for k, v in m.named_buffers() if "running" in k}
        return float(loss), {k: g.double().cpu() for k, g in grads.items()}, stats

    runs = {(dev, str(dt).removeprefix("torch.")): step_grads(dev, dt)
            for dev in ("cuda", "cpu") for dt in (torch.float64, torch.float32)}
    out["card_vs_cpu"] = {}
    for dt, (loss_tol, grad_tol, stats_tol) in (("float64", CLS_F64_TOL),
                                                 ("float32", (CLS_LOSS_RTOL, None,
                                                              CLS_STATS_TOL))):
        (l_card, g_card, s_card), (l_cpu, g_cpu, s_cpu) = runs["cuda", dt], runs["cpu", dt]
        rec = dict(loss_card=l_card, loss_cpu=l_cpu, loss_rel=abs(l_card - l_cpu) / abs(l_cpu),
                   grad_rel=_grad_ratios(g_card, g_cpu), stats_rel=_grad_ratios(s_card, s_cpu))
        # fp32's own spread: each device's fp32 gradients against its float64 ones.
        if dt == "float32":
            rec["card_f32_vs_f64"] = _grad_ratios(g_card, runs["cuda", "float64"][1])
            rec["cpu_f32_vs_f64"] = _grad_ratios(g_cpu, runs["cpu", "float64"][1])
        out["card_vs_cpu"][dt] = rec
        wg = max(rec["grad_rel"], key=rec["grad_rel"].get)
        ws = max(rec["stats_rel"], key=rec["stats_rel"].get)
        spread = "" if dt == "float64" else (
            "; fp32's own spread, each device's fp32 gradients against its float64 ones: card "
            f"worst {max(rec['card_f32_vs_f64'].values()):.3e}, median "
            f"{statistics.median(rec['card_f32_vs_f64'].values()):.3e}; CPU worst "
            f"{max(rec['cpu_f32_vs_f64'].values()):.3e}, median "
            f"{statistics.median(rec['cpu_f32_vs_f64'].values()):.3e} (the gradients are not "
            "held in fp32: the CPU alone misses 1e-2 against float64)")
        say("classifier", f"one train step at full width (ResNet-50, {N_CLASSES} classes, "
            f"{RES}², batch {CLS_CPU_BATCH}, the same flips), {dt}, TF32 off, card against the "
            f"host CPU: loss {l_card:.9f} / {l_cpu:.9f} (relative {rec['loss_rel']:.3e}, "
            f"tolerance {loss_tol:g}); {len(rec['grad_rel'])} gradients, max |card - CPU| / "
            f"the leaf's max: worst {wg} {rec['grad_rel'][wg]:.3e}, median "
            f"{statistics.median(rec['grad_rel'].values()):.3e}"
            + (f" (tolerance {grad_tol:g})" if grad_tol else " (reported)")
            + f"; {len(rec['stats_rel'])} BN running statistics after the forward: worst {ws} "
            f"{rec['stats_rel'][ws]:.3e} (tolerance {stats_tol:g})" + spread)
        assert rec["loss_rel"] <= loss_tol, (dt, rec["loss_rel"])
        assert grad_tol is None or rec["grad_rel"][wg] <= grad_tol, (dt, wg, rec["grad_rel"][wg])
        assert rec["stats_rel"][ws] <= stats_tol, (dt, ws, rec["stats_rel"][ws])
    del runs

    # The step's time at batch 32, TF32 at PyTorch's defaults.
    tf32_defaults(device)
    batch = torch.from_numpy(seeded_images(CLS_BATCH, SEED + 112)).cuda()
    blabels = torch.from_numpy(rng.integers(0, N_CLASSES, CLS_BATCH)).cuda()
    from torch.profiler import ProfilerActivity, profile

    for dtype in ("float32", "bfloat16"):
        m = pw.classifier_from_tree(tree, "cuda")
        state = TC.create_classifier_state(m, TC.ClassifierTrainingParams(), 100)
        step = TC.make_classifier_train_step(dtype)

        def one(i):
            loss, _ = step(state, batch, blabels, TC.draw_flips(SEED, i, CLS_BATCH, "cuda"))
            return loss

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(13):
            t0 = time.perf_counter()
            loss = float(one(i))
            times.append((time.perf_counter() - t0) * 1e3)
        assert math.isfinite(loss), loss
        med = statistics.median(times[3:])
        peak = torch.cuda.max_memory_allocated() / 2**20
        one(13)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(14, 17):
                one(i)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy = sum(e.self_device_time_total for e in kernel_events(prof)) / 1e3
        out[dtype] = dict(step_ms=times, step_ms_median=med, img_per_s=CLS_BATCH / med * 1e3,
                          peak_mib=peak, busy_ms=busy, wall_ms=wall, busy_share=busy / wall)
        say("classifier", f"train step {dtype}, batch {CLS_BATCH}, {RES}²: median "
            f"{med:.2f} ms of 10 after 3 (min {min(times[3:]):.2f}), {CLS_BATCH / med * 1e3:.1f} "
            f"img/s, peak memory {peak:.0f} MiB; 3 profiled steps: device kernels {busy:.1f} ms "
            f"of {wall:.1f} ms = {100 * busy / wall:.1f}% busy; {card}")
        del m, state
        torch.cuda.empty_cache()

    # The commands: train from the ported classifier, test its output.
    args = ["train", "classifier", "--dataset", "synthetic", "--epochs", "2", "--batch-size",
            "16", "--checkpoints", "checkpoints/synthetic/classifier-synthetic",
            "--output-weights", "classifier-trained"]
    run_command("train_classifier", args, work, out)
    recs = read_jsonl(os.path.join(work, "classifier_2.jsonl"))
    assert len(recs) == 2 and all(math.isfinite(v) for r in recs for v in r.values()), recs
    best = max(r["test_accuracy"] for r in recs)
    test_args = ["test", "classifier", "--dataset", "synthetic", "--batch-size", "16",
                 "--checkpoints", "classifier-trained"]
    log = run_command("test_classifier", test_args, work, out)
    assert f"Accuracy: {100 * best:.2f}%" in log, (best, log[-1000:])
    # As `train viscoin` loads checkpoints/<dataset>/classifier-<dataset>.
    load_jax_tree(Classifier(output_classes=10, device="cuda"),
                  ckpt.restore_pytree(os.path.join(work, "classifier-trained")))
    out["records"] = recs
    say("classifier", f"python -m viscoin_tpu_torch {' '.join(args)} ({PIPE_N} images of "
        f"{RES}², on the card): {out['train_classifier_s']:.1f} s, test accuracy per epoch "
        + ", ".join(f"{r['test_accuracy']:.4f}" for r in recs)
        + f"; `{' '.join(test_args)}` reports the best epoch's {100 * best:.2f}% "
        f"({out['test_classifier_s']:.1f} s); the output loads into train viscoin's "
        f"classifier; {card}")
    return out


# -------------------------------- the GAN tools ------------------------------- #

# `dataset-tool`, `generate`, `style-mixing`, `project` and `fid` at the JAX
# command's full widths, in the pipeline's directory: the ported 256²
# generator (z = w = 512, 2 mapping layers, channel_base 16384, channel_max
# 512) at checkpoints/synthetic/gan-synthetic, LPIPS-VGG and Inception.
TOOLS_N = 32  # synthetic source images packed by dataset-tool
TOOLS_GAN = "checkpoints/synthetic/gan-synthetic"
PROJ_STEPS = 100  # `project --steps` here; the command's default is 1000
PROJ_CPU_STEPS = 3
# The projection card vs CPU (TF32 off, the same draws): step 0's gradients
# (w and every noise buffer) of each leaf's largest, and after 3 steps w,
# every buffer and the losses of their largest. Adam divides each component
# by its own running RMS, so a component with a small gradient carries its
# rounding into a full-size update (the CPU tests: 2.8e-4 of w in fp32
# against float64 at toy widths).
PROJ_GRAD_TOL, PROJ_TOL = 1e-3, 1e-2
PPL_SAMPLES, PPL_BATCH, PPL_CPU_SEGMENTS = 64, GAN_BATCH, 4
PPL_TOL = 1e-2  # per-segment distances, card vs CPU (TF32 off), of the largest


class FirstOrderFault:
    """A planted fault, for the control of the projection check: while
    active, bias_act's first-order backward (the launches of bias_act_grad a
    projection step makes) takes the lrelu slope GAN_FAULT_ALPHA where the
    forward takes 0.2."""

    def __enter__(self):
        orig = self._orig = ba._BiasAct.backward

        def backward(ctx, dy):
            args = ctx.args
            if args["act"] == "lrelu":
                ctx.args = {**args, "alpha": GAN_FAULT_ALPHA}
            try:
                return orig(ctx, dy)
            finally:
                ctx.args = args

        ba._BiasAct.backward = staticmethod(backward)
        return self

    def __exit__(self, *exc):
        ba._BiasAct.backward = staticmethod(self._orig)


def _quiet_main(argv: list[str]) -> str:
    """``python -m viscoin_tpu_torch <argv>`` in this process; its standard
    output. Raises on a non-zero exit."""
    with contextlib.redirect_stdout(io.StringIO()) as log:
        code = _port_main(argv)
    assert code == 0, (argv, code, log.getvalue()[-2000:])
    return log.getvalue()


def _png(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def _u8_dev(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.astype(np.int64) - b).max())


def _frozen_lpips(device):
    lp = load_jax_tree(LPIPS(device=device), {"params": ckpt.restore_pytree(
        "checkpoints/lpips-vgg")})
    return lp.eval().requires_grad_(False)


def tools_dataset(out: dict, card: str) -> None:
    """dataset-tool: TOOLS_N synthetic images of several sizes, written as a
    folder per class, packed at RES²; each member equals host_gan_transform
    of its source."""
    import zipfile

    from PIL import Image

    from viscoin_tpu_torch.data.transforms import host_gan_transform

    src = SyntheticDataset(n=TOOLS_N, image_size=RES, mode="train")
    sources = {}
    for i in range(TOOLS_N):
        rel = f"c{i % 4}/{i:03d}.png"
        os.makedirs(os.path.join("tools_src", os.path.dirname(rel)), exist_ok=True)
        sources[rel] = src._load_raw(i)
        Image.fromarray(sources[rel]).save(os.path.join("tools_src", rel))
    t0 = time.perf_counter()
    log = _quiet_main(["dataset-tool", "--source", "tools_src", "--dest", "packed.zip",
                       "--resolution", str(RES)])
    out["dataset_tool_s"] = time.perf_counter() - t0
    with zipfile.ZipFile("packed.zip") as zf:
        names = sorted(n for n in zf.namelist() if n.endswith(".png"))
        assert len(names) == TOOLS_N, names
        for name, rel in zip(names, sorted(sources)):
            got = np.asarray(Image.open(io.BytesIO(zf.read(name))).convert("RGB"))
            assert np.array_equal(got, host_gan_transform(sources[rel], size=RES)), (name, rel)
    say("gan-tools", f"{log.strip()}: {TOOLS_N} synthetic images of "
        f"{min(s.shape[0] for s in sources.values())}-{max(s.shape[0] for s in sources.values())}"
        f" rows in 4 class folders, {out['dataset_tool_s']:.2f} s; every member's pixels equal "
        f"host_gan_transform of its source; {card}")


def tools_generate(out: dict, device: dict) -> dict:
    """generate --seeds 0-15 --batch-size 16 twice (TF32 at PyTorch's
    defaults, as a user runs it): bit-equal PNGs (and, as a control, the
    distance of a run without the command's deterministic cuDNN); the same seeds at other
    batch positions (--seeds 8-23); 2 seeds card (TF32 off) against the host
    CPU at full width, within 1 u8 level; a batch of 16 timed by events.
    Returns the generate batch's kernel calls."""
    from viscoin_tpu_torch.cli import generate as gen_cmd
    from viscoin_tpu_torch.cli.generate import seed_latents
    from viscoin_tpu_torch.cli.utils import load_generator

    card = device["nvidia_smi"]
    base = ["generate", "--gan", TOOLS_GAN]
    walls = []
    for outdir, seeds in (("gen_a", "0-15"), ("gen_b", "0-15"), ("gen_shift", "8-23")):
        t0 = time.perf_counter()
        _quiet_main([*base, "--seeds", seeds, "--batch-size", "16", "--outdir", outdir])
        walls.append(time.perf_counter() - t0)
    same = all(np.array_equal(_png(f"gen_a/seed{s:04d}.png"), _png(f"gen_b/seed{s:04d}.png"))
               for s in range(16))
    assert same, "generate is not reproducible on the card"
    # The control: the same run with cuDNN's default (atomic) algorithms.
    orig = gen_cmd.deterministic_cudnn
    gen_cmd.deterministic_cudnn = contextlib.nullcontext
    try:
        _quiet_main([*base, "--seeds", "0-15", "--batch-size", "16", "--outdir", "gen_nd"])
    finally:
        gen_cmd.deterministic_cudnn = orig
    out["nondeterministic_u8"] = max(_u8_dev(_png(f"gen_a/seed{s:04d}.png"),
                                             _png(f"gen_nd/seed{s:04d}.png")) for s in range(16))
    out["batch_position_u8"] = max(_u8_dev(_png(f"gen_a/seed{s:04d}.png"),
                                           _png(f"gen_shift/seed{s:04d}.png"))
                                   for s in range(8, 16))
    set_tf32(False)
    _quiet_main([*base, "--seeds", "0-1", "--batch-size", "2", "--outdir", "gen_card"])
    t0 = time.perf_counter()
    _quiet_main([*base, "--seeds", "0-1", "--batch-size", "2", "--outdir", "gen_cpu",
                 "--device", "cpu"])
    out["generate_cpu_s"] = time.perf_counter() - t0
    tf32_defaults(device)
    out["card_vs_cpu_u8"] = max(_u8_dev(_png(f"gen_card/seed{s:04d}.png"),
                                        _png(f"gen_cpu/seed{s:04d}.png")) for s in (0, 1))
    out["card_tf32_vs_cpu_u8"] = max(_u8_dev(_png(f"gen_a/seed{s:04d}.png"),
                                             _png(f"gen_cpu/seed{s:04d}.png")) for s in (0, 1))
    assert out["card_vs_cpu_u8"] <= 1, out
    g = load_generator(TOOLS_GAN, "cuda")
    z = seed_latents(list(range(16)), g.z_dim).cuda()
    with torch.no_grad():
        out["batch16_ms"] = cuda_ms(lambda: g(z, noise_mode="const"), iters=10)
        with PathRecorder() as rec:
            g(z, noise_mode="const")
    out["generate_s"] = walls
    out["img_per_s"] = 16 / out["batch16_ms"] * 1e3
    say("gan-tools", f"generate --seeds 0-15 --batch-size 16 twice (TF32 at PyTorch's defaults): "
        f"the 16 PNGs bit-equal ({walls[0]:.2f} / {walls[1]:.2f} s a command, the generator's "
        f"load included; control, without cuDNN's deterministic algorithms: max "
        f"{out['nondeterministic_u8']} u8 levels from the first run); the same seeds at other "
        f"batch positions (--seeds 8-23): max "
        f"{out['batch_position_u8']} u8 levels apart; seeds 0-1 on the card with TF32 off against "
        f"the host CPU at full width ({out['generate_cpu_s']:.1f} s): max "
        f"{out['card_vs_cpu_u8']} u8 levels (tolerance 1; with TF32 at the defaults "
        f"{out['card_tf32_vs_cpu_u8']}); a batch of 16 (mapping + synthesis, no_grad, const "
        f"noise) {out['batch16_ms']:.2f} ms by events = {out['img_per_s']:.0f} img/s; {card}")
    del g
    return rec.unique()


def tools_style_mixing(out: dict, card: str) -> None:
    """style-mixing with the defaults (rows 85,100,75, cols 55,821,1789,
    col-styles 0-6): the grid and 15 cells; then every layer from the column
    seed: each cell equals its column image."""
    from PIL import Image

    from viscoin_tpu_torch.models.stylegan import num_ws_for_resolution

    t0 = time.perf_counter()
    _quiet_main(["style-mixing", "--gan", TOOLS_GAN, "--outdir", "mix"])
    out["style_mixing_s"] = time.perf_counter() - t0
    with Image.open("mix/grid.png") as grid:
        assert grid.size == (4 * RES, 4 * RES), grid.size
    grid = _png("mix/grid.png")
    assert not grid[:RES, :RES].any() and grid[RES:, RES:].any()
    assert np.array_equal(grid[RES: 2 * RES, 2 * RES: 3 * RES], _png("mix/85-821.png"))
    num_ws = num_ws_for_resolution(RES)
    _quiet_main(["style-mixing", "--gan", TOOLS_GAN, "--outdir", "mix_full", "--col-styles",
                 f"0-{num_ws - 1}"])
    rows, cols = (85, 100, 75), (55, 821, 1789)
    out["full_mask_u8"] = max(_u8_dev(_png(f"mix_full/{r}-{c}.png"), _png(f"mix_full/{c}-{c}.png"))
                              for r in rows for c in cols)
    assert out["full_mask_u8"] <= 1, out
    say("gan-tools", f"style-mixing with the defaults: grid.png {4 * RES}x{4 * RES} with a black "
        f"corner and 15 cells, {out['style_mixing_s']:.2f} s; --col-styles 0-{num_ws - 1}: every "
        f"cell (r, c) within {out['full_mask_u8']} u8 levels of its column image (c, c), which "
        f"sits at another batch position (tolerance 1); {card}")


def tools_project(out: dict, device: dict) -> dict:
    """`project --steps PROJ_STEPS` on a generated image (the loss falls);
    then the projector in this process: launches per step exactly those of
    the same steps on the CPU at narrow widths, per-step ms, peak memory and
    the busy share, its kernel calls recorded; 3 steps card against the
    host CPU (TF32 off, the same draws) and the control under
    FirstOrderFault. Returns the timed run's kernel calls."""
    from viscoin_tpu_torch.cli.utils import load_generator
    from viscoin_tpu_torch.eval import projection as PJ
    from viscoin_tpu_torch.models.stylegan import num_ws_for_resolution

    card = device["nvidia_smi"]
    tf32_defaults(device)
    t0 = time.perf_counter()
    log = _quiet_main(["project", "--gan", TOOLS_GAN, "--target", "gen_a/seed0003.png",
                       "--steps", str(PROJ_STEPS), "--outdir", "proj"])
    out["command_s"] = time.perf_counter() - t0
    saved = np.load("proj/projected_w.npz")
    losses = saved["losses"]
    assert saved["w"].shape == (num_ws_for_resolution(RES), 512)
    assert losses.shape == (PROJ_STEPS,)
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert _png("proj/proj.png").shape == _png("proj/target.png").shape == (RES, RES, 3)
    out["command_losses"] = [float(losses[0]), float(losses[-1])]

    # The launches a step makes, from the same projection on the CPU at
    # narrow widths (LPIPS launches none of the port's kernels: a stand-in).
    narrow = init_models(Generator(z_dim=8, w_dim=8, img_resolution=RES, channel_base=256,
                                   channel_max=8, mapping_layers=2, device="cpu"), 1)
    narrow.eval().requires_grad_(False)
    mse = lambda x, y: (x - y).square().mean(dim=(1, 2, 3))  # noqa: E731
    zero = torch.zeros(1, 3, RES, RES)

    def narrow_run(n):
        PJ.make_projector(narrow, mse, num_steps=n)(zero, PJ.draw_projection(narrow, n))

    c1, c2 = count_plain_calls(lambda: narrow_run(1)), count_plain_calls(lambda: narrow_run(2))
    per_step = {k: c2[k] - c1[k] for k in KERNELS}
    start = {k: c1[k] - per_step[k] for k in KERNELS}

    g, lp = load_generator(TOOLS_GAN, "cuda"), _frozen_lpips("cuda")
    target = torch.from_numpy(_png("proj/target.png").astype(np.float32) / 127.5 - 1.0)
    target = target.permute(2, 0, 1)[None].contiguous()
    draws = PJ.draw_projection(g, PROJ_STEPS, seed=0).to("cuda")
    project = PJ.make_projector(g, lp, num_steps=PROJ_STEPS)
    marks = []

    def on_step(i, grads):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), _kernels.launch_counts()))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    with PathRecorder() as rec:
        t0 = time.perf_counter()
        _, _, losses = project(target.cuda(), draws, on_step)
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    steps = [marks[0][1]] + [{k: b[1][k] - a[1][k] for k in KERNELS}
                             for a, b in zip(marks, marks[1:])]
    assert steps[0] == {k: start[k] + per_step[k] for k in KERNELS}, (steps[0], start, per_step)
    assert all(s == per_step for s in steps[1:]), (steps[1:3], per_step)
    assert per_step["bias_act_grad"] > 0 and per_step["upfirdn2d"] > 0
    calls = rec.unique()
    assert {n: sum(m for c, m in calls.items() if c[0] == n) for n in KERNELS} == \
        _kernels.launch_counts()
    assert all(c[1][0] == 1 for c in calls if c[0] == "upfirdn2d"), "a FIR not at batch 1"
    assert not any(c[3][2] for c in calls if c[0] == "bias_act_grad" and c[3][0] is not None)
    step_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(marks, marks[1:])]
    out.update(launches_per_step=per_step, launches_start=start,
               launches=_kernels.launch_counts(), step_ms_median=statistics.median(step_ms),
               step_ms_min=min(step_ms), first_step_ms=(marks[0][0] - t0) * 1e3,
               losses=[float(losses[0]), float(losses[-1])])

    # The busy share of 5 steps under the profiler.
    from torch.profiler import ProfilerActivity, profile

    five = PJ.make_projector(g, lp, num_steps=5)
    d5 = PJ.draw_projection(g, 5, seed=2).to("cuda")
    five(target.cuda(), d5)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        five(target.cuda(), d5)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = kernel_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    out.update(profiled_wall_ms=wall, profiled_device_ms=busy, busy_share=busy / wall,
               device_kernels_per_step=sum(e.count for e in events) / 5)

    # 3 steps card against the host CPU, TF32 off, the same draws.
    set_tf32(False)
    d3 = PJ.draw_projection(g, PROJ_CPU_STEPS, seed=1)
    names = ["w"] + PJ.noise_buffer_names(g)

    def run3(gen, lpips, dev, fault=False):
        first = {}

        def keep(i, grads):
            if i == 0:
                first.update({n: t.detach().float().cpu() for n, t in zip(names, grads)})

        with FirstOrderFault() if fault else contextlib.nullcontext():
            w, noise, ls = PJ.make_projector(gen, lpips, num_steps=PROJ_CPU_STEPS)(
                target.to(dev), d3.to(dev), keep)
        state = {"w": w.cpu(), "losses": ls.cpu(), **{k: v.cpu() for k, v in noise.items()}}
        return first, state

    t0 = time.perf_counter()
    cpu = run3(load_generator(TOOLS_GAN, "cpu"), _frozen_lpips("cpu"), "cpu")
    out["cpu_3_steps_s"] = time.perf_counter() - t0
    got, bad = run3(g, lp, "cuda"), run3(g, lp, "cuda", fault=True)
    tf32_defaults(device)
    grads, traj = grad_ratios(got[0], cpu[0]), grad_ratios(got[1], cpu[1])
    bad_grads = grad_ratios(bad[0], cpu[0])
    wg, wt, wb = (max(r, key=r.get) for r in (grads, traj, bad_grads))
    out.update(grad_rel_err=grads, state_rel_err=traj, control_grad_rel_err=bad_grads)
    say("gan-tools", f"project --steps {PROJ_STEPS} on gen_a/seed0003.png at full width (TF32 at "
        f"the defaults): loss {out['command_losses'][0]:.4f} -> {out['command_losses'][1]:.4f}, "
        f"{out['command_s']:.1f} s the command; in this process: launches per step {per_step} "
        f"(+ {start} before the first: the w_avg mapping), exactly the same projection's plain "
        f"calls on the CPU at narrow widths; every FIR at batch 1, every bias_act_grad without "
        f"db; per step median {out['step_ms_median']:.2f} ms (min {out['step_ms_min']:.2f}, "
        f"synchronised each step; the first {out['first_step_ms']:.1f} ms with the w_avg "
        f"mapping of 2048 z), peak memory {out['peak_mib']:.0f} MiB, 5 profiled steps "
        f"{busy:.1f} ms device in {wall:.1f} ms ({100 * busy / wall:.1f}% busy, "
        f"{out['device_kernels_per_step']:.0f} device kernels a step); {card}")
    say("gan-tools", f"projection card vs the host CPU (TF32 off, the same draws, "
        f"{out['cpu_3_steps_s']:.1f} s on the CPU): step 0's gradients, worst {wg} "
        f"{grads[wg]:.3e} (tolerance {PROJ_GRAD_TOL:g}); after {PROJ_CPU_STEPS} steps, worst "
        f"{wt} {traj[wt]:.3e} (tolerance {PROJ_TOL:g}; w {traj['w']:.3e}, losses "
        f"{traj['losses']:.3e}); control, the card under FirstOrderFault (lrelu slope "
        f"{GAN_FAULT_ALPHA} in the first-order backward): step 0's gradients worst {wb} "
        f"{bad_grads[wb]:.3e} (must miss {PROJ_GRAD_TOL:g}); {card}")
    assert grads[wg] <= PROJ_GRAD_TOL, (wg, grads[wg])
    assert traj[wt] <= PROJ_TOL, (wt, traj[wt])
    assert bad_grads[wb] > PROJ_GRAD_TOL, ("the control passed", wb, bad_grads[wb])
    del g, lp
    return calls


def tools_ppl(out: dict, device: dict) -> dict:
    """fid --metric ppl --samples PPL_SAMPLES --batch-size PPL_BATCH (TF32 at
    the defaults: the module turns it off and back); the first
    PPL_CPU_SEGMENTS segments card against the host CPU (TF32 off); the same
    with TF32 on, and through the one-pass LPIPS form of the JAX package; a
    batch timed; the whole PPL with TF32 on. Returns one batch's kernel
    calls."""
    from viscoin_tpu_torch.cli.utils import load_generator
    from viscoin_tpu_torch.eval import ppl as PPL

    card = device["nvidia_smi"]
    tf32_defaults(device)
    t0 = time.perf_counter()
    log = _quiet_main(["fid", "--gan", TOOLS_GAN, "--metric", "ppl", "--samples",
                       str(PPL_SAMPLES), "--batch-size", str(PPL_BATCH)])
    out["command_s"] = time.perf_counter() - t0
    res = json.loads(log.strip().splitlines()[-1])
    assert math.isfinite(res["ppl"]) and res["ppl"] > 0, res
    assert torch.backends.cudnn.allow_tf32 == device["cudnn_tf32_default"]
    out["ppl"] = res["ppl"]

    g, lp = load_generator(TOOLS_GAN, "cuda"), _frozen_lpips("cuda")
    d = PPL.ppl_draws(0, 0, PPL_BATCH, g.z_dim)
    d4 = PPL.PPLDraws(*(x[:PPL_CPU_SEGMENTS] for x in d))
    card4 = PPL.make_ppl_sampler(g, lp)(d4).double().cpu()
    t0 = time.perf_counter()
    g_cpu, lp_cpu = load_generator(TOOLS_GAN, "cpu"), _frozen_lpips("cpu")
    cpu4 = PPL.make_ppl_sampler(g_cpu, lp_cpu)(d4).double()
    out["cpu_s"] = time.perf_counter() - t0
    with torch.no_grad():
        set_tf32(True)
        img = PPL.path_pair_images(g, d4, 1e-4)
        n = PPL_CPU_SEGMENTS
        tf32 = (lp.normalized_difference(img[:n], img[n:]) / 1e-8).double().cpu()
        set_tf32(False)
        img = PPL.path_pair_images(g, d4, 1e-4)
        one_pass = (lp(img[:n], img[n:]) / 1e-8).double().cpu()
    tf32_defaults(device)

    def rel(a):
        return float((a - cpu4).abs().max() / cpu4.abs().max())

    out.update(segments_card=card4.tolist(), segments_cpu=cpu4.tolist(),
               segments_tf32=tf32.tolist(), segments_one_pass=one_pass.tolist(),
               card_vs_cpu=rel(card4), tf32_vs_cpu=rel(tf32), one_pass_vs_cpu=rel(one_pass))
    # The whole PPL with TF32 on (no_tf32 made a no-op).
    orig = PPL.no_tf32
    PPL.no_tf32 = contextlib.nullcontext
    set_tf32(True)
    try:
        out["ppl_tf32"] = PPL.compute_ppl(g, lp, PPL_SAMPLES, PPL_BATCH)
    finally:
        PPL.no_tf32 = orig
        tf32_defaults(device)
    sample = PPL.make_ppl_sampler(g, lp)
    out["batch_ms"] = cuda_ms(lambda: sample(d), iters=5, warmup=1)
    _kernels.reset_launch_counts()
    with PathRecorder() as rec:
        sample(d)
    out["launches_per_batch"] = _kernels.launch_counts()
    say("gan-tools", f"fid --metric ppl --samples {PPL_SAMPLES} --batch-size {PPL_BATCH} "
        f"(TF32 at the defaults outside, off inside): ppl {out['ppl']:.4f} "
        f"({out['command_s']:.1f} s); the first {PPL_CPU_SEGMENTS} segments card against the "
        f"host CPU, TF32 off: max |card - CPU| / max CPU = {out['card_vs_cpu']:.3e} (tolerance "
        f"{PPL_TOL:g}; CPU {out['cpu_s']:.1f} s); with TF32 on {out['tf32_vs_cpu']:.3e}; the JAX "
        f"package's one-pass LPIPS form (TF32 off) {out['one_pass_vs_cpu']:.3e}; the whole PPL "
        f"with TF32 on {out['ppl_tf32']:.4f}; a batch of {PPL_BATCH} segments (2 x "
        f"{PPL_BATCH} images) {out['batch_ms']:.2f} ms by events, launches "
        f"{out['launches_per_batch']}; {card}")
    assert out["card_vs_cpu"] <= PPL_TOL, out
    del g, lp, g_cpu, lp_cpu
    return rec.unique()


def tools_fid(out: dict, device: dict) -> None:
    """fid --dataset packed.zip --metric fid --metric kid --metric pr
    --samples 64 --batch-size 16 under cuDNN deterministic: one host matrix
    square root; the features it was given equal a recomputation here, and
    KID and precision/recall equal theirs."""
    from viscoin_tpu_torch.cli.train import _load_fid_detector
    from viscoin_tpu_torch.cli.utils import load_generator
    from viscoin_tpu_torch.data.utils import get_datasets
    from viscoin_tpu_torch.eval import fid as EF

    card = device["nvidia_smi"]
    tf32_defaults(device)
    seen = {}
    orig = EF.fid_from_stats

    def spy(real, fake):
        t0 = time.perf_counter()
        seen.update(real=real.get_all(), fake=fake.get_all(), fid=orig(real, fake))
        seen["sqrtm_s"] = time.perf_counter() - t0
        return seen["fid"]

    EF.fid_from_stats = spy
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        log = _quiet_main(["fid", "--gan", TOOLS_GAN, "--dataset", "packed.zip", "--metric",
                           "fid", "--metric", "kid", "--metric", "pr", "--samples", "64",
                           "--batch-size", "16"])
        out["command_s"] = time.perf_counter() - t0
        res = json.loads(log.strip().splitlines()[-1])
        detect = _load_fid_detector("checkpoints/inception", torch.device("cuda"))
        fake_fn, real_fn = TG.make_gan_fid_fns(16)
        ds, _ = get_datasets("packed.zip", "gan", train_only=True, out_size=RES)
        real = TG.accumulate_real_fid_stats(detect, real_fn, ds, 16, 64, capture_all=True,
                                            device="cuda")
        fake = TG.accumulate_fake_fid_stats(detect, fake_fn, load_generator(TOOLS_GAN, "cuda"),
                                            0, 64, capture_all=True)
    finally:
        EF.fid_from_stats = orig
        torch.backends.cudnn.deterministic = False
    assert np.array_equal(real.get_all(), seen["real"]) and np.array_equal(fake.get_all(),
                                                                           seen["fake"])
    assert res["fid"] == seen["fid"] and res["real_items"] == TOOLS_N
    assert res["kid"] == EF.kid_from_stats(real, fake, seed=0)
    assert (res["precision"], res["recall"]) == EF.pr_from_stats(real, fake)
    out.update(result=res, sqrtm_s=seen["sqrtm_s"])
    say("gan-tools", f"fid --dataset packed.zip --metric fid --metric kid --metric pr --samples 64 "
        f"--batch-size 16, cuDNN deterministic: fid {res['fid']:.6g}, kid {res['kid']:.6g}, "
        f"precision {res['precision']:.4f}, recall {res['recall']:.4f} over {TOOLS_N} real "
        f"(the whole zip) and 64 fake samples, {out['command_s']:.1f} s, of which the one "
        f"2048² matrix square root on the host {seen['sqrtm_s']:.1f} s; the features it was "
        f"given equal a recomputation here, KID and precision/recall equal theirs; {card}")


def phase_gan_tools(work: str, device: dict) -> tuple[dict, dict]:
    """The GAN tools in the pipeline's directory (see the constants above).
    Returns (record, {path label: kernel calls}): the generate batch, the
    projection's timed run and one PPL batch."""
    out: dict = {k: {} for k in ("dataset_tool", "generate", "style_mixing", "project", "ppl",
                                 "fid")}
    card = device["nvidia_smi"]
    t_start = time.perf_counter()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        tools_dataset(out["dataset_tool"], card)
        gen_calls = tools_generate(out["generate"], device)
        tools_style_mixing(out["style_mixing"], card)
        proj_calls = tools_project(out["project"], device)
        torch.cuda.empty_cache()
        ppl_calls = tools_ppl(out["ppl"], device)
        torch.cuda.empty_cache()
        tools_fid(out["fid"], device)
    finally:
        os.chdir(cwd)
    out["seconds"] = time.perf_counter() - t_start
    say("gan-tools", f"the phase took {out['seconds']:.1f} s; {card}")
    return out, {"the generate batch": gen_calls, "the projection's timed steps": proj_calls,
                 "one PPL batch": ppl_calls}


# ------------------------------ the analysis phase ---------------------------- #

ANALYSIS_N, ANALYSIS_TEST_N = 64, 20  # SyntheticDataset images (200 classes, 256²)
SERVE_TOL = 1e-5  # the serve subprocess against the in-process engine, of the scale
# amplify's probabilities, served against in-process: the generator's transposed
# convolutions take cuDNN's atomic algorithms (see `generate`'s control), so its
# images differ by a u8 level between runs, and the classifier (TF32) reads that.
AMPLIFY_TOL = 1e-3
EXPLAIN_TOL = 1e-3  # heatmaps card (TF32 off) vs CPU, absolute (the maps lie in [0, 1])
PAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # a row alone vs in a padded batch, absolute
CONCEPTS_RTOL = 1e-4  # test_concepts card (TF32 off) vs CPU, of each field's scale


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, float(np.abs(want).max())))


def _narrow_models():
    """The bundle at narrow widths on the CPU (toy classifier, 8 concepts,
    channel_base 256, channel_max 8) at RES with the flagship's mapping
    (one layer per group, both groups): it launches what the flagship
    launches, counted by ``count_plain_calls``."""
    from viscoin_tpu_torch.models.bundle import VisCoINModels
    from viscoin_tpu_torch.models.concept_extractor import ConceptExtractor
    from viscoin_tpu_torch.models.explainer import Explainer
    from viscoin_tpu_torch.models.resnet import Classifier
    from viscoin_tpu_torch.models.stylegan import GeneratorAdapted

    return init_models(VisCoINModels(
        classifier=Classifier(output_classes=N_CLASSES, embedding_size=8,
                              hidden_sizes=(8, 16, 32, 64), depths=(1, 1, 1, 1), device="cpu"),
        concept_extractor=ConceptExtractor(n_concepts=8, latent_channels=8, input_channels1=16,
                                           input_channels2=32, input_channels3=64, device="cpu"),
        explainer=Explainer(n_concepts=8, n_classes=N_CLASSES, device="cpu"),
        gan=GeneratorAdapted(z_dim=8, img_resolution=RES, channel_base=256, channel_max=8,
                             device="cpu")), SEED + 95).eval()


def analysis_serve(models, bundle: str, device: dict) -> dict:
    """`python -m viscoin_tpu_torch serve --compute-dtype float32 --port 0` in a
    process of its own on the saved bundle: its printed address, /healthz,
    then /v1/classify, /v1/reconstruct, /v1/explain and /v1/amplify against
    the in-process engine (the same TF32 defaults); SIGINT stops it, exit 0
    with its batchers closed."""
    card = device["nvidia_smi"]
    tf32_defaults(device)  # what the subprocess runs with
    srv = ServeProcess(["--viscoin-pickle-path", bundle, "--compute-dtype", "float32"])
    out: dict = {}
    try:
        t_warm, _ = srv.wait_for(r"warming up")
        t_up, match = srv.wait_for(r"serving on (http://\S+)")
        base = match.group(1)
        out.update(load_s=t_warm - srv.t0, warmup_s=t_up - t_warm, startup_s=t_up - srv.t0)
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["device"].startswith("cuda"), health
        assert health["compute_dtype"] == "float32" and health["batch_size"] == BATCH, health

        imgs = seeded_images(3, SEED + 90)
        engine = InferenceEngine(models, batch_size=BATCH, compute_dtype="float32",
                                 device="cuda")
        err: dict[str, float] = {}
        cls = json.loads(_post(base, "/v1/classify?top_k=5", imgs))
        want = engine.classify(imgs)
        assert cls["preds"] == want["logits"].argmax(-1).tolist()
        assert cls["expl_preds"] == want["expl_logits"].argmax(-1).tolist()
        for key, idx, src in (("top_probas", "top_classes", "probas"),
                              ("top_expl_probas", "top_expl_classes", "expl_probas"),
                              ("top_concept_activations", "top_concepts", "concepts")):
            err[f"classify {key}"] = _rel(cls[key], np.take_along_axis(
                want[src], np.asarray(cls[idx]), -1))
        rec = np.load(io.BytesIO(_post(base, "/v1/reconstruct", imgs)))
        want = engine.reconstruct(imgs)
        err["reconstruct u8"] = float(_u8_dev(rec["reconstruction_u8"],
                                              want["reconstruction_u8"]))
        expl = np.load(io.BytesIO(_post(base, "/v1/explain?top_k=5", imgs)))
        want = engine.explain(imgs)
        np.testing.assert_array_equal(expl["expl_preds"], want["expl_preds"])
        np.testing.assert_array_equal(expl["preds"], want["preds"])
        for i in range(1, 6):
            err[f"explain heatmap_conv{i}"] = _rel(expl[f"heatmap_conv{i}"],
                                                   want[f"heatmap_conv{i}"])
        err["explain top_concept_activations"] = _rel(
            expl["top_concept_activations"],
            np.take_along_axis(want["concepts"], expl["top_concepts"], -1))
        amp = np.load(io.BytesIO(_post(base, "/v1/amplify?top_k_concepts=4&seed=3", imgs[:1])))
        res = engine.amplify(imgs[0], {"method": "top_k", "k": 4}, [0.0, 1.0, 2.0, 4.0], seed=3)
        want_u8 = np.round(np.clip(np.stack(res.amplified_images) * np.asarray(
            IMAGENET_STD, np.float32) + np.asarray(IMAGENET_MEAN, np.float32), 0, 1)
            * 255).astype(np.uint8)
        err["amplify u8"] = float(_u8_dev(amp["amplified_u8"], want_u8))
        err["amplify probas"] = _rel(np.concatenate([amp["probas_best"], amp["probas_rand"]]),
                                     res.best_concept_probas_best + res.best_concept_probas_rand)
        del engine
        for key, e in err.items():
            assert e <= (1 if "u8" in key else AMPLIFY_TOL if "amplify" in key else SERVE_TOL), \
                (key, e)
        out["errors"] = err
        code = srv.stop()
        assert code == 0, (code, "".join(srv.log)[-3000:])
        assert any("micro-batchers closed" in ln for ln in srv.log), "".join(srv.log)[-3000:]
    finally:
        srv.kill()
    say("analysis", f"`python -m viscoin_tpu_torch serve --compute-dtype float32 --port 0` "
        f"(batch {BATCH}) in its own process: up in {out['startup_s']:.1f} s (interpreter, "
        f"torch and the bundle's load {out['load_s']:.1f} s, warm-up of the three batched "
        f"endpoints {out['warmup_s']:.1f} s); /v1/classify, /v1/reconstruct, /v1/explain and "
        f"/v1/amplify against the in-process engine: "
        + ", ".join(f"{k} {v:.3g}" for k, v in err.items())
        + f" (tolerance {SERVE_TOL:g} of the scale, amplify's probabilities {AMPLIFY_TOL:g}, 1 "
        f"u8 level); SIGINT: exit 0, micro-batchers "
        f"closed; {card}")
    return out


def _explain_timing(engine, imgs: np.ndarray) -> dict:
    """An explain batch: the host clock around engine.explain (it returns
    numpy, so the device work has finished; median of 10), CUDA events over
    10 calls, and the profiler's kernel time over 5 calls against their wall."""
    from torch.profiler import ProfilerActivity, profile

    engine.explain(imgs)
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        engine.explain(imgs)
        times.append((time.perf_counter() - t0) * 1e3)
    events = cuda_ms(lambda: engine.explain(imgs), iters=10)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            engine.explain(imgs)
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in kernel_events(prof)) / 1e3
    med = statistics.median(times)
    return {"host_ms_median": med, "host_ms_min": min(times), "events_ms": events,
            "img_per_s": len(imgs) / med * 1e3, "busy_share": busy / wall,
            "device_ms_per_batch": busy / 5}


def analysis_explain(models, cpu_models, device: dict) -> dict:
    """explain on 10 images (two device batches of 8) in fp32 and bf16: no
    kernel launch, two calls bit-equal, a row alone equal to the same row in
    a padded batch; fp32 card (TF32 off) against device="cpu" on 2 images,
    and a planted fault (the gradient of another class than the explained
    one) that check must catch; an explain batch timed (TF32 at the
    defaults)."""
    from viscoin_tpu_torch.utils import cudnn as cudnn_mod
    from viscoin_tpu_torch.utils.gradcam import concept_extractor_gradcams

    card = device["nvidia_smi"]
    imgs = seeded_images(10, SEED + 91)
    out: dict = {}
    for dtype in ("float32", "bfloat16"):
        set_tf32(False)
        engine = InferenceEngine(models, batch_size=BATCH, compute_dtype=dtype, device="cuda")
        engine.explain(imgs[:BATCH])
        _kernels.reset_launch_counts()
        a = engine.explain(imgs)
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
        assert counts == {k: 0 for k in KERNELS}, (dtype, counts)
        b = engine.explain(imgs)
        for key in a:
            assert np.array_equal(a[key], b[key]), (dtype, "two explain calls differ", key)
        # The control: two calls with cuDNN's default algorithms in the backward.
        orig = cudnn_mod.deterministic_cudnn
        cudnn_mod.deterministic_cudnn = contextlib.nullcontext
        try:
            c, d = engine.explain(imgs), engine.explain(imgs)
        finally:
            cudnn_mod.deterministic_cudnn = orig
        nondet = max(float(np.abs(c[k] - d[k]).max()) for k in c if k.startswith("heatmap"))
        maps = [f"heatmap_conv{i}" for i in range(1, 6)]
        for key in maps:
            m = a[key]
            assert m.shape == (10, RES // 32, RES // 32) and m.dtype == np.float32, (key, m.shape)
            assert np.isfinite(m).all() and m.min() >= 0 and m.max() <= 1, key
        live = [k for k in maps if a[k].std() > 0]
        assert live, "every heatmap is constant: the check would be vacuous"
        three = engine.explain(imgs[:3])
        pad = max(float(np.abs(three[k][i] - engine.explain(imgs[i])[k][0]).max())
                  for i in range(3) for k in maps)
        assert pad <= PAD_TOL[dtype], (dtype, pad)
        tf32_defaults(device)
        timing = _explain_timing(engine, imgs[:BATCH])
        out[dtype] = {"launches": counts, "padding_dev": pad, "live_maps": live,
                      "nondeterministic_dev": nondet, **timing}
        say("analysis", f"explain {dtype}, 10 images (batches of {BATCH}): heatmaps "
            f"{a['heatmap_conv1'].shape} per conv in [0, 1] (not constant: {', '.join(live)}); "
            f"kernel launches {counts}; two calls bit-equal (control, cuDNN's default "
            f"algorithms: {nondet:.3g} apart); a row alone vs in a padded batch {pad:.3g} "
            "(tolerance "
            f"{PAD_TOL[dtype]:g}); a batch of {BATCH} (TF32 at the defaults): host median "
            f"{timing['host_ms_median']:.2f} ms (min {timing['host_ms_min']:.2f}) = "
            f"{timing['img_per_s']:.1f} img/s, events {timing['events_ms']:.2f} ms, device "
            f"{timing['device_ms_per_batch']:.2f} ms, busy {100 * timing['busy_share']:.1f}%; "
            f"{card}")
        del engine
        torch.cuda.empty_cache()
    set_tf32(False)
    card_eng = InferenceEngine(models, batch_size=2, device="cuda")
    cpu_eng = InferenceEngine(cpu_models, batch_size=2, device="cpu")
    got, want = card_eng.explain(imgs[:2]), cpu_eng.explain(imgs[:2])
    np.testing.assert_array_equal(got["expl_preds"], want["expl_preds"])
    err = max(float(np.abs(got[f"heatmap_conv{i}"] - want[f"heatmap_conv{i}"]).max())
              for i in range(1, 6))
    logit_err = _rel(got["expl_logits"], want["expl_logits"])
    assert err <= EXPLAIN_TOL, ("explain card vs CPU", err)
    # The control: heatmaps of another class than the explained one.
    wrong = torch.from_numpy((want["expl_preds"] + 1) % N_CLASSES).cuda()
    x = device_preprocess(torch.from_numpy(imgs[:2]).cuda())
    maps, _ = concept_extractor_gradcams(card_eng.models, x, wrong)
    fault = max(float(np.abs(maps[f"conv{i}"] - want[f"heatmap_conv{i}"]).max())
                for i in range(1, 6))
    assert fault > EXPLAIN_TOL, ("the wrong-class control passed the check", fault)
    out.update(card_vs_cpu=err, card_vs_cpu_logits=logit_err, control=fault)
    say("analysis", f"explain fp32 card (TF32 off) vs device=\"cpu\", 2 images at full width: "
        f"heatmaps {err:.3g} (tolerance {EXPLAIN_TOL:g}), explainer logits {logit_err:.3g} of "
        f"their scale, predictions equal; control (the gradient of the next class): "
        f"{fault:.3g}, caught; {card}")
    return out


def analysis_concepts(models, cpu_models, device: dict) -> dict:
    """test_concepts over ANALYSIS_N synthetic test images (200 classes,
    256², batches of 32, the native loader): no kernel launch; the card's
    part (``concept_sums``: the accuracies and the summed statistics, TF32
    off) against the CPU's within CONCEPTS_RTOL of each sum's scale, the
    accuracies equal; the statistics derived from each reported (their
    per-concept min-max normalization divides by a weak concept's own
    maximum); img/s of the card's second run."""
    from viscoin_tpu_torch.eval.concepts import concept_results, concept_sums, test_concepts

    card = device["nvidia_smi"]
    ds = SyntheticDataset(n=ANALYSIS_N, n_classes=N_CLASSES, image_size=RES, mode="test")
    loader = DataLoader(ds, 32, shuffle=False)
    set_tf32(False)
    _kernels.reset_launch_counts()
    sums = concept_sums(models, loader, N_CLASSES)
    counts = _kernels.launch_counts()
    assert counts == {k: 0 for k in KERNELS}, counts
    t0 = time.perf_counter()
    test_concepts(models, loader, N_CLASSES)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_sums = concept_sums(cpu_models, loader, N_CLASSES)
    cpu_s = time.perf_counter() - t0
    assert (sums["cls_accs"], sums["expl_accs"]) == (cpu_sums["cls_accs"],
                                                     cpu_sums["expl_accs"]), (sums, cpu_sums)
    errs = {k: _rel(sums[k], cpu_sums[k]) for k in cpu_sums if k not in ("cls_accs",
                                                                         "expl_accs")}
    assert max(errs.values()) <= CONCEPTS_RTOL, errs
    got, want = concept_results(sums), concept_results(cpu_sums)
    fields = {k: _rel(getattr(got, k), getattr(want, k)) for k in got.__dataclass_fields__
              if isinstance(getattr(got, k), np.ndarray)}
    say("analysis", f"test_concepts, {ANALYSIS_N} synthetic images (200 classes, {RES}², "
        f"batches of 32): kernel launches {counts}; card (TF32 off) vs CPU: accuracies equal "
        f"({got.classifier_accuracy:.4f}, {got.explainer_accuracy:.4f}), the summed statistics "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" of their scale (tolerance {CONCEPTS_RTOL:g}); the fields derived from them "
        + ", ".join(f"{k} {v:.3g}" for k, v in fields.items())
        + f"; the card's second run {card_s:.2f} s = {ANALYSIS_N / card_s:.1f} img/s (loader "
        f"included), the CPU's {cpu_s:.1f} s; {card}")
    return {"launches": counts, "errors": errs, "field_errors": fields, "card_s": card_s,
            "img_per_s": ANALYSIS_N / card_s, "cpu_s": cpu_s}


def analysis_w_plus(models, cpu_models, device: dict) -> tuple[dict, dict]:
    """compute_w_space over ANALYSIS_N train and ANALYSIS_TEST_N test images:
    bias_act launches exactly those of the same pass on the CPU at narrow
    widths, upfirdn2d none; W+ card (TF32 off) vs CPU on the first batch;
    then amplify-pca --pca 2 --image 0's computation
    (cli/amplify_pca.py::w_plus_pca) in the command's layout: launches
    exactly the CPU's narrow count, its kernel calls recorded (the mapping
    at N = 32, the synthesis at N = 5), one component's images card against
    CPU within 1 u8 level. Returns (record, the amplify-pca calls)."""
    from viscoin_tpu_torch.cli import amplify_pca
    from viscoin_tpu_torch.data.utils import get_datasets
    from viscoin_tpu_torch.eval.spaces import compute_w_space, run_over

    card = device["nvidia_smi"]
    kw = dict(n_classes=N_CLASSES, image_size=RES, transform="test")
    train_ds = SyntheticDataset(n=ANALYSIS_N, mode="train", **kw)
    test_ds = SyntheticDataset(n=ANALYSIS_TEST_N, mode="test", **kw)
    narrow = _narrow_models()
    want = count_plain_calls(lambda: compute_w_space(narrow, "synthetic", train_ds, test_ds,
                                                     cache_dir="narrow_w"))
    set_tf32(False)
    _kernels.reset_launch_counts()
    train_w, test_w = compute_w_space(models, "synthetic", train_ds, test_ds, cache_dir="w")
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    assert counts == want and counts["upfirdn2d"] == 0, (counts, want)
    assert train_w.shape == (ANALYSIS_N, models.gan.num_ws, 512) and np.isfinite(train_w).all()
    w_cpu = run_over(cpu_models, [train_ds[i] for i in range(BATCH)], BATCH, "w")
    w_err = _rel(train_w[:BATCH], w_cpu)
    assert w_err <= 1e-3, w_err
    tf32_defaults(device)
    t0 = time.perf_counter()
    run_over(models, train_ds, 32, "w")
    w_s = time.perf_counter() - t0

    # amplify-pca --pca 2 --image 0: SyntheticDataset from the environment.
    env = {k: os.environ.get(k) for k in ("VISCOIN_SYNTH_N", "VISCOIN_SYNTH_SIZE")}
    os.environ.update(VISCOIN_SYNTH_N=str(ANALYSIS_N), VISCOIN_SYNTH_SIZE=str(RES))
    try:
        os.makedirs("narrow", exist_ok=True)
        os.chdir("narrow")
        try:
            pca_want = count_plain_calls(lambda: amplify_pca.w_plus_pca(narrow, "synthetic", 2, 0))
        finally:
            os.chdir("..")
        set_tf32(False)
        _kernels.reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()), PathRecorder() as rec:
            index, images = amplify_pca.w_plus_pca(models, "synthetic", 2, 0)
        torch.cuda.synchronize()
        pca_counts = _kernels.launch_counts()
        # The command's W+ cache, which the command just wrote.
        train_pca, test_pca = compute_w_space(models, "synthetic",
                                              *get_datasets("synthetic", "test"))
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert pca_counts == pca_want, (pca_counts, pca_want)
    calls = rec.unique()
    shapes = {(c[0], c[1][0]) for c in calls}
    assert ("upfirdn2d", 5) in shapes and ("bias_act", 32) in shapes, shapes
    assert images.shape == (2, 5, RES, RES, 3) and np.isfinite(images).all()
    comps = amplify_pca.pca_components(train_pca, 1)
    t0 = time.perf_counter()
    cpu_imgs = amplify_pca.pca_images(cpu_models, test_pca[index], comps)
    pca_cpu_s = time.perf_counter() - t0
    card_imgs = amplify_pca.pca_images(models, test_pca[index], comps)
    pca_u8 = _u8_dev(np.round(card_imgs * 255), np.round(cpu_imgs * 255))
    assert pca_u8 <= 1, pca_u8
    tf32_defaults(device)
    say("analysis", f"compute_w_space, {ANALYSIS_N} + {ANALYSIS_TEST_N} images in batches of "
        f"32 (f, Psi and the adapted mapping): launches {counts}, exactly the CPU's count at "
        f"narrow widths, no upfirdn2d; W+ card (TF32 off) vs CPU {w_err:.3g} of its scale; a "
        f"pass over {ANALYSIS_N} images (the host's decode included, TF32 at the defaults) "
        f"{w_s:.2f} s = {ANALYSIS_N / w_s:.1f} img/s; {card}")
    say("analysis", f"amplify-pca --pca 2 --image 0 (cli/amplify_pca.py::w_plus_pca, "
        f"{ANALYSIS_N} train + {ANALYSIS_N} test images): launches {pca_counts}, exactly the "
        f"CPU's count at narrow widths; {len(calls)} distinct kernel calls, the mapping at N = "
        f"32 and the synthesis at N = 5; one component's 5 images card (TF32 off) vs CPU "
        f"{pca_u8} u8 levels (tolerance 1; the CPU {pca_cpu_s:.1f} s); {card}")
    return ({"launches": counts, "w_vs_cpu": w_err, "w_s": w_s, "img_per_s": ANALYSIS_N / w_s,
             "amplify_pca": {"launches": pca_counts, "card_vs_cpu_u8": pca_u8}}, calls)


# The figures of the analysis commands: {command: {PNG name: (width, height)}},
# each figsize x 100 pixels (two amplified images, --pca 2, 5 heatmap rows).
FIGURES = {
    "amplify": {"amplify": (1500, 1000)},
    "amplify-pca": {"amplify_pca_0": (1500, 1000)},
    "concepts": dict.fromkeys(["concept_activation_per_concept", "concept_activation_per_image",
                               "class_concept_correlations", "concept_class_correlations",
                               "concept_entropies"], (640, 480)),
    "concept-heatmaps": {"concept_heatmaps": (2000, 1000)},
    "logs": dict.fromkeys(["training_losses", "testing_losses", "preds_overlap"], (640, 480)),
}


def analysis_commands(models, bundle: str, loop_jsonl: str, device: dict,
                      pca_launches: dict) -> tuple[dict, dict]:
    """amplify, amplify-pca --pca 2, concepts, concept-heatmaps and logs as
    commands on the card with matplotlib unimportable
    (``sys.modules["matplotlib"] = None``): each command's launches and wall;
    its PNGs read back with PIL, each of its figure's size and each image
    panel exactly ``plotting.panel_pixels`` of the array the figure kept;
    amplify's panels against the in-process ``amplify_images`` arrays after
    the same resampling within 1 u8 level; launches: amplify 2x the
    generator's per image, amplify-pca the CPU's narrow count
    (``pca_launches``, its W+ pass included: it runs in a directory without
    the cache), the others none. Then to-pickle (it draws nothing) on a raw
    checkpoint of the JAX command's default hyperparameters. Returns (record,
    amplify's kernel calls)."""
    import importlib.util

    from viscoin_tpu_torch.cli import amplify
    from viscoin_tpu_torch.data.utils import get_datasets
    from viscoin_tpu_torch.utils import plotting
    from viscoin_tpu_torch.utils.images import from_torch
    from viscoin_tpu_torch.utils.weights import bundle_to_jax_tree

    card = device["nvidia_smi"]
    out: dict = {"matplotlib_installed": importlib.util.find_spec("matplotlib") is not None,
                 "font": plotting.font_kind(), "walls": {}, "launches": {}}
    say("analysis", f"figures: {out['font']}; the host has matplotlib: "
        f"{out['matplotlib_installed']} (hidden from the commands either way)")
    with open("loop_a.jsonl", "w") as f:
        f.write(loop_jsonl)
    figs = os.path.abspath("figs")
    common = ["--viscoin-pickle-path", bundle, "--dataset", "synthetic", "--outdir", figs]
    drawing = {"amplify": [*common, "--concept-top-k", "4", "--image-indices", "0,1"],
               "amplify-pca": [*common, "--pca", "2", "--image", "0"],
               "concepts": [*common, "--batch-size", "32"],
               "concept-heatmaps": common,
               "logs": ["--logs-path", "loop_a.jsonl", "--outdir", figs]}
    figures, save = {}, plotting.save_figure

    def keep(fig, outdir, name):
        figures[name] = fig
        return save(fig, outdir, name)

    env = {k: os.environ.get(k) for k in ("VISCOIN_SYNTH_N", "VISCOIN_SYNTH_SIZE")}
    had = sys.modules.get("matplotlib", False)
    sys.modules["matplotlib"] = None  # as on a host without it: importing raises
    plotting.save_figure = keep
    cwd = os.getcwd()
    try:
        for name, args in drawing.items():
            # amplify-pca as analysis_w_plus ran it, in a directory without its W+ cache
            n = ANALYSIS_N if name == "amplify-pca" else 8
            os.environ.update(VISCOIN_SYNTH_N=str(n), VISCOIN_SYNTH_SIZE=str(RES))
            if name == "amplify-pca":
                os.makedirs("pca_command")
                os.chdir("pca_command")
            recorder = PathRecorder() if name == "amplify" else contextlib.nullcontext()
            _kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with recorder:
                _quiet_main([name, *args])
            torch.cuda.synchronize()
            out["walls"][name] = time.perf_counter() - t0
            out["launches"][name] = _kernels.launch_counts()
            if name == "amplify":
                amp_calls = recorder.unique()
            os.chdir(cwd)
        os.environ.update(VISCOIN_SYNTH_N="8", VISCOIN_SYNTH_SIZE=str(RES))
        _, test_ds = get_datasets("synthetic")
        originals, amplified = amplify.amplify_images(
            models, test_ds, [0, 1], {"method": "top_k", "k": 4}, amplify.MULTIPLIERS,
            np.random.default_rng(SEED))
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
        plotting.save_figure = save
        if had is False:
            sys.modules.pop("matplotlib", None)
        else:
            sys.modules["matplotlib"] = had
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    none = {k: 0 for k in KERNELS}
    want = {"amplify": {k: 2 * n for k, n in expected_launches(models).items()},
            "amplify-pca": pca_launches, "concepts": none, "concept-heatmaps": none,
            "logs": none}
    assert out["launches"] == want, (out["launches"], want)
    names = {n: size for sizes in FIGURES.values() for n, size in sizes.items()}
    assert sorted(os.listdir(figs)) == sorted(f"{n}.png" for n in names), os.listdir(figs)
    assert sorted(figures) == sorted(names), sorted(figures)
    panels = 0
    for name, (w, h) in names.items():
        png = _png(os.path.join(figs, f"{name}.png"))
        assert png.shape == (h, w, 3) and figures[name].size == (w, h), (name, png.shape)
        for ax in figures[name].axes:
            if ax.images:
                x0, y0, x1, y1 = ax.box
                panels += 1
                assert np.array_equal(png[y0:y1, x0:x1],
                                      plotting.panel_pixels(ax.images[-1], (x1 - x0, y1 - y0)))
    # amplify's panels against this process's images of the same indices
    grid = figures["amplify"].grid
    refs = [[from_torch(o), *(from_torch(a) for a in row)] for o, row in zip(originals, amplified)]
    assert grid.shape == (2, 1 + len(amplify.MULTIPLIERS)), grid.shape
    png = _png(os.path.join(figs, "amplify.png"))
    amp_u8 = 0
    for (i, j), ax in np.ndenumerate(grid):
        x0, y0, x1, y1 = ax.box
        amp_u8 = max(amp_u8, _u8_dev(png[y0:y1, x0:x1],
                                     plotting.panel_pixels(refs[i][j], (x1 - x0, y1 - y0))))
    assert amp_u8 <= 1, amp_u8
    out.update(figures=sorted(names), panels_exact=panels, amplify_panels_u8=amp_u8)
    say("analysis", "amplify, amplify-pca --pca 2, concepts, concept-heatmaps, logs as commands "
        "on the card, matplotlib unimportable: walls "
        + ", ".join(f"{k} {v:.2f} s" for k, v in out["walls"].items())
        + f"; launches amplify {out['launches']['amplify']} (2 images, one generator pass of "
        f"2M + 1 each), amplify-pca {out['launches']['amplify-pca']} (the CPU's narrow count, "
        f"its W+ pass included), the others none; {len(names)} PNGs of their figures' sizes, "
        f"{panels} image panels each exactly the renderer's resampling of its array; amplify's "
        f"{grid.size} panels against this process's amplify_images {amp_u8} u8 levels "
        f"(tolerance 1); {card}")
    raw_models = default_models(device="cuda", seed=SEED + 96)
    ckpt.save_pytree(bundle_to_jax_tree(raw_models), "raw")
    t0 = time.perf_counter()
    log = _quiet_main(["to-pickle", "--checkpoints", "raw", "--output", "picked"])
    out["to_pickle_s"] = time.perf_counter() - t0
    got = ckpt.load_viscoin_bundle("picked", device="cuda").state_dict()
    want = raw_models.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want), "to-pickle changed a weight"
    del raw_models, got, want
    say("analysis", f"to-pickle: {log.strip()} ({out['to_pickle_s']:.1f} s; the JAX command's "
        f"default widths, channel_base 32768), reloaded bit-equal; {card}")
    return out, amp_calls


def phase_analysis(models, device: dict, loop_jsonl: str, tmp: str) -> tuple[dict, dict]:
    """serve's command, explain, test_concepts, the W+ pass, amplify-pca and
    the analysis commands on the flagship bundle, saved to ``tmp`` as
    ``viscoin-flagship``. Returns (record, {label: the kernel calls of
    amplify-pca's computation and of the amplify command})."""
    out: dict = {}
    t_start = time.perf_counter()
    cwd = os.getcwd()
    try:
        bundle = os.path.join(tmp, "viscoin-flagship")
        ckpt.save_viscoin(models, bundle)
        out["serve"] = analysis_serve(models, bundle, device)
        cpu_models = default_models(N_CLASSES, N_CONCEPTS, RES, CHANNEL_BASE, CHANNEL_MAX,
                                    device="cpu", seed=SEED)
        cpu_models.load_state_dict({k: v.cpu() for k, v in models.state_dict().items()})
        out["explain"] = analysis_explain(models, cpu_models, device)
        out["concepts"] = analysis_concepts(models, cpu_models, device)
        os.chdir(tmp)
        out["w_space"], pca_calls = analysis_w_plus(models, cpu_models, device)
        del cpu_models
        out["commands"], amp_calls = analysis_commands(
            models, bundle, loop_jsonl, device, out["w_space"]["amplify_pca"]["launches"])
    finally:
        os.chdir(cwd)
        tf32_defaults(device)
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_start
    say("analysis", f"the phase took {out['seconds']:.1f} s; {device['nvidia_smi']}")
    return out, {"amplify-pca --pca 2": pca_calls, "amplify --concept-top-k 4": amp_calls}


# ---------------------------- the concept2clip phase -------------------------- #

C2C_N = PIPE_N  # synthetic images per split for `train concept2clip` (VISCOIN_SYNTH_N)
C2C_EPOCHS = 3  # `--epochs` here; the command's default is 30
CLIP_TOL = 1e-4  # CLIP card (TF32 off) vs CPU, of the embeddings' scale
C2C_RTOL = 1e-5  # one epoch's losses card (TF32 off) vs CPU, relative
C2C_CHECK_BATCH = 24  # the card-vs-CPU epoch's batch: ragged test batches (24, 24, 16)
C2C_KEYS = {"train_loss", "test_loss", "matching_accuracy"}  # the JAX trainer's records


def caption_merges(captions: list[str], n: int) -> list[str]:
    """``n`` merges learnt from the captions' words by byte-pair counting,
    in the format of CLIP's merges file (one "a b" pair per line)."""
    import collections
    import re

    words = collections.Counter(tuple(w[:-1]) + (w[-1] + "</w>",) for c in captions
                                for w in re.findall(r"[a-z]+", c.lower()))
    merges = []
    for _ in range(n):
        pairs = collections.Counter()
        for w, k in words.items():
            for pair in zip(w, w[1:]):
                pairs[pair] += k
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append(f"{a} {b}")
        merged = collections.Counter()
        for w, k in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == (a, b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += k
        words = merged
    return merges


def perturb_all(module, seed: int) -> None:
    """Every leaf + 0.1 x its spread (or x 1 where it is constant) x N(0, 1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            spread = float(p.std()) if p.numel() > 1 else 0.0
            p.add_((0.1 * (spread or 1.0)) * torch.randn(p.shape, device=p.device,
                                                         generator=gen))


def clip_source(kind: str, seed: int) -> dict[str, np.ndarray]:
    """A seeded state_dict of a CLIP checkpoint at its manifest's full
    shapes: N(0, 0.02) floats, HF's position_ids as HF stores them."""
    rng = np.random.default_rng(seed)
    man = porting.load_manifest(kind)
    sd = {}
    for part in ("required", "optional"):
        for k, shape in man[part].items():
            if k.endswith("position_ids"):
                sd[k] = np.arange(shape[-1], dtype=np.int64)[None]
            elif k in ("context_length", "input_resolution", "vocab_size"):
                sd[k] = np.asarray({"context_length": 77, "input_resolution": 224,
                                    "vocab_size": 49408}[k])
            else:
                sd[k] = (0.02 * rng.standard_normal(shape, dtype=np.float32)).astype(np.float32)
    return sd


class FunctionWalls:
    """Host (start, end) seconds of each call of the named module functions
    while the context is open (each returns numpy or a Python float: its
    device work has finished when it returns)."""

    def __init__(self, targets: dict[str, tuple]):
        self.targets = targets  # label -> (module, function name)
        self.spans: dict[str, list[tuple[float, float]]] = {label: [] for label in targets}
        self._orig = {label: getattr(mod, name) for label, (mod, name) in targets.items()}

    def __enter__(self):
        for label, (mod, name) in self.targets.items():
            def timed(*args, _f=self._orig[label], _label=label, **kw):
                t0 = time.perf_counter()
                try:
                    return _f(*args, **kw)
                finally:
                    self.spans[_label].append((t0, time.perf_counter()))
            setattr(mod, name, timed)
        return self

    def walls(self, label: str) -> list[float]:
        return [end - start for start, end in self.spans[label]]

    def epochs(self) -> list[float]:
        """Each epoch of the trainer: from its start, or the end of the
        previous epoch's test pass, to the end of the epoch's test pass."""
        (start, _), = self.spans["trainer"]
        ends = [end for _, end in self.spans["test_pass"]]
        return [b - a for a, b in zip([start, *ends], ends)]

    def __exit__(self, *exc):
        for label, (mod, name) in self.targets.items():
            setattr(mod, name, self._orig[label])


class UnshuffledTestLoader:
    """A planted fault: the trainer's test loader in its stored order (the
    reference shuffles it on purpose). The card-vs-CPU epoch must see it."""

    def __enter__(self):
        import viscoin_tpu_torch.train.concept2clip as TC

        self._mod, self._orig = TC, TC.TensorLoader
        TC.TensorLoader = lambda x, y, bs, shuffle=True, seed=0: self._orig(
            x, y, bs, shuffle=False, seed=seed)
        return self

    def __exit__(self, *exc):
        self._mod.TensorLoader = self._orig


def c2c_epoch(spaces: tuple, embs: tuple, device: str, seed_model, log: str) -> dict:
    """One epoch of train_concept2clip at C2C_CHECK_BATCH from the given
    initial adapter on ``device``; its record."""
    from viscoin_tpu_torch.models.concept2clip import Concept2CLIP
    from viscoin_tpu_torch.train.concept2clip import Concept2ClipTrainingParams, train_concept2clip

    model = Concept2CLIP(n_concepts=seed_model.config["n_concepts"], device=device)
    model.load_state_dict(seed_model.state_dict())
    configure_score_logging(log)
    with contextlib.redirect_stdout(io.StringIO()):
        train_concept2clip(model, spaces[0], embs[0], spaces[1], embs[1],
                           Concept2ClipTrainingParams(epochs=1, batch_size=C2C_CHECK_BATCH))
    (rec,) = read_jsonl(log)
    return rec


def c2c_deviation(got: dict, want: dict) -> tuple[float, bool]:
    """(the largest relative loss deviation, whether the matching accuracies
    are equal)."""
    dev = max(abs(got[k] - want[k]) / abs(want[k]) for k in ("train_loss", "test_loss"))
    return dev, got["matching_accuracy"] == want["matching_accuracy"]


def c2c_clip(device: dict) -> dict:
    """(a): CLIP ViT-B/32 at full width from seeded weights, every leaf
    perturbed: encode_image on 8 seeded 224² inputs and encode_text on 8
    captions (tokenized with merges learnt here), card (TF32 off) against
    device="cpu"; the EOT rows; encode_image at batch 32 fp32 timed."""
    from viscoin_tpu_torch.captions import cub
    from viscoin_tpu_torch.models.clip import CLIP, SimpleTokenizer, clip_preprocess_u8

    card = device["nvidia_smi"]
    clip = init_models(CLIP(device="cuda"), SEED + 110)
    perturb_all(clip, SEED + 111)
    cpu = CLIP(device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in clip.state_dict().items()})
    n_params = sum(p.numel() for p in clip.parameters())
    u8 = torch.from_numpy(np.random.default_rng(SEED + 112).integers(
        0, 256, (8, 224, 224, 3), dtype=np.uint8))
    captions = cub.load()
    with open("merges.txt.gz", "wb") as raw:
        import gzip

        with gzip.open(raw, "wt", encoding="utf-8") as f:
            f.write("\n".join(["#version: 0.2", *caption_merges(captions, 200)]))
    tok = SimpleTokenizer("merges.txt.gz")
    picked = [captions[i] for i in range(0, len(captions), len(captions) // 8)][:8]
    tokens = torch.from_numpy(tok.tokenize(picked).astype(np.int64))
    eot = tok.encoder["<|endoftext|>"]
    lengths = [2 + len(tok.encode(c)) for c in picked]
    assert all(tokens[i, n - 1] == eot and tokens[i, n:].eq(0).all()
               for i, n in enumerate(lengths)), (tokens, lengths)
    assert tokens.argmax(dim=1).tolist() == [n - 1 for n in lengths]
    set_tf32(False)
    with torch.no_grad():
        img_card = clip.encode_image(clip_preprocess_u8(u8.cuda())).cpu()
        img_cpu = cpu.encode_image(clip_preprocess_u8(u8))
        txt_card = clip.encode_text(tokens.cuda()).cpu()
        txt_cpu = cpu.encode_text(tokens)
        # The row after the EOT token never reaches it (the causal mask).
        noisy = tokens.clone()
        for i, n in enumerate(lengths):
            noisy[i, n:] = torch.randint(1, eot, (77 - n,), generator=torch.Generator()
                                         .manual_seed(i))
        txt_noisy = clip.encode_text(noisy.cuda()).cpu()
    img_err, txt_err = _rel(img_card, img_cpu), _rel(txt_card, txt_cpu)
    eot_err = _rel(txt_noisy, txt_card)
    assert img_err <= CLIP_TOL and txt_err <= CLIP_TOL, (img_err, txt_err)
    assert eot_err <= 1e-6, eot_err
    assert float(img_cpu.abs().max()) > 0 and float(txt_cpu.abs().max()) > 0
    del cpu
    tf32_defaults(device)
    x = clip_preprocess_u8(torch.from_numpy(np.random.default_rng(SEED + 113).integers(
        0, 256, (32, 256, 256, 3), dtype=np.uint8)).cuda())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    with torch.no_grad():
        for i in range(13):
            t0 = time.perf_counter()
            clip.encode_image(x).cpu()
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**20
    say("concept2clip", f"(a) CLIP ViT-B/32 ({n_params / 1e6:.2f} M parameters, seeded, every "
        f"leaf perturbed): encode_image on 8 seeded 224² inputs card (TF32 off) vs CPU "
        f"{img_err:.3g} of the scale, encode_text on 8 captions {txt_err:.3g} (tolerance "
        f"{CLIP_TOL:g}); the EOT rows at the tokens' argmax, unmoved by the ids after them "
        f"({eot_err:.3g}); encode_image at batch 32 fp32 (TF32 at the defaults): median "
        f"{med:.2f} ms of 10 after 3 (min {min(times):.2f}), {32 / med * 1e3:.1f} img/s, "
        f"peak {peak:.0f} MiB; {card}")
    return {"params_m": n_params / 1e6, "image_vs_cpu": img_err, "text_vs_cpu": txt_err,
            "eot_rows": eot_err, "encode_image_b32_ms": med, "encode_image_b32_min_ms":
            min(times), "img_per_s": 32 / med * 1e3, "peak_mib": peak}


def c2c_port_weights(device: dict) -> dict:
    """(b): `port-weights clip` on seeded sources in the OpenAI and HF
    layouts at the manifests' full shapes: each clean against its manifest;
    `--strict` loads it on the card and writes it (the OpenAI one to the
    default checkpoints/clip/vit-b-32, which `train concept2clip` reads
    below); `--check` exits 1 on a mis-shaped copy; the written CLIP's
    image embeddings equal an in-process conversion's bit for bit."""
    from viscoin_tpu_torch.cli.port_weights import clip_from_params
    from viscoin_tpu_torch.models.clip import CLIP_CHECKPOINT, clip_preprocess_u8

    card = device["nvidia_smi"]
    out: dict = {}
    x = clip_preprocess_u8(torch.from_numpy(np.random.default_rng(SEED + 114).integers(
        0, 256, (4, 224, 224, 3), dtype=np.uint8)).cuda())
    set_tf32(False)
    for kind, convert, dst in (("clip_openai", porting.convert_torch_clip, CLIP_CHECKPOINT),
                               ("clip_hf", porting.convert_hf_clip, "clip-hf")):
        sd = clip_source(kind, SEED + 115)
        assert porting.validate_state_dict(sd, kind) == [], kind
        torch.save(_torch_sd(sd), f"{kind}.pt")
        t0 = time.perf_counter()
        log = _quiet_main(["port-weights", "clip", f"{kind}.pt", dst, "--strict"])
        out[f"{kind}_s"] = time.perf_counter() - t0
        assert f"manifest check [{kind}]: OK" in log, log
        bad = dict(sd)
        key = next(k for k in sd if k.endswith("proj.weight") or k.endswith("proj"))
        bad[key] = sd[key][:, :-1]
        torch.save(_torch_sd(bad), "bad.pt")
        del bad
        with contextlib.redirect_stdout(io.StringIO()):
            code = _port_main(["port-weights", "clip", "bad.pt", "--check"])
        assert code == 1, (kind, code)
        with torch.no_grad():
            written = clip_from_params(ckpt.restore_pytree(dst), "cuda").encode_image(x)
            direct = clip_from_params(convert(sd), "cuda").encode_image(x)
        assert torch.equal(written, direct), kind
        del sd
        os.remove(f"{kind}.pt")
        os.remove("bad.pt")
    tf32_defaults(device)
    say("concept2clip", f"(b) port-weights clip: seeded OpenAI and HF sources at the manifests' "
        "full shapes, each clean against its manifest; --strict loaded each on the card and "
        f"wrote it ({out['clip_openai_s']:.1f} s, {out['clip_hf_s']:.1f} s; the OpenAI one to "
        f"{CLIP_CHECKPOINT}); --check exited 1 on a mis-shaped copy; the written CLIP's image "
        f"embeddings equal an in-process conversion's bit for bit; {card}")
    return out


def c2c_command(bundle: str, device: dict) -> tuple[dict, dict]:
    """(c): `train concept2clip --dataset synthetic --epochs 3` at 256² with
    C2C_N images per split, --latent-type viscoin then gan: launches (none
    for viscoin; for gan exactly the W+ pass's count of the same pass on the
    CPU at narrow widths, no upfirdn2d), the jsonl, the checkpoint reloaded
    bit-equal, export-concept2clip and back bit-equal, the walls of the CLIP
    pass, the space passes and an epoch; then one epoch from the same
    cached spaces and embeddings card (TF32 off) against the CPU, and the
    same under UnshuffledTestLoader, which that check must catch. Returns
    (record, the gan run's kernel calls)."""
    import viscoin_tpu_torch.eval.spaces as TS
    import viscoin_tpu_torch.models.clip as TCL
    import viscoin_tpu_torch.train.concept2clip as TC
    from viscoin_tpu_torch.cli.port_weights import concept2clip_from_params
    from viscoin_tpu_torch.data.utils import get_datasets
    from viscoin_tpu_torch.eval.spaces import compute_w_space
    from viscoin_tpu_torch.models.concept2clip import Concept2CLIP

    card = device["nvidia_smi"]
    out: dict = {}
    os.makedirs("checkpoints/synthetic")
    os.symlink(bundle, "checkpoints/synthetic/viscoin-synthetic")
    env = {k: os.environ.get(k) for k in ("VISCOIN_SYNTH_N", "VISCOIN_SYNTH_SIZE")}
    os.environ.update(VISCOIN_SYNTH_N=str(C2C_N), VISCOIN_SYNTH_SIZE=str(RES))
    try:
        narrow = _narrow_models()
        datasets = get_datasets("synthetic", "test")  # the command's
        want_w = count_plain_calls(lambda: compute_w_space(narrow, "synthetic", *datasets,
                                                           cache_dir="narrow_w"))
        del narrow
        walls = {"clip_pass": (TCL, "compute_image_embeddings"),
                 "concept_pass": (TS, "compute_concept_space"),
                 "w_pass": (TS, "compute_w_space"),
                 "trainer": (TC, "train_concept2clip"),
                 "test_pass": (TC, "test_concept2clip")}
        calls = {}
        for latent in ("viscoin", "gan"):
            tf32_defaults(device)
            _kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with FunctionWalls(walls) as fw, PathRecorder() as rec:
                log = _quiet_main(["train", "concept2clip", "--dataset", "synthetic",
                                   "--epochs", str(C2C_EPOCHS), "--latent-type", latent,
                                   "--output-weights", f"c2c-{latent}"])
            torch.cuda.synchronize()
            counts = _kernels.launch_counts()
            run = {"s": time.perf_counter() - t0, "launches": counts, "epochs": fw.epochs(),
                   "walls": {k: fw.walls(k) for k in walls if fw.spans[k]}}
            if latent == "viscoin":
                assert set(counts.values()) == {0}, counts
            else:
                assert counts == want_w and counts["upfirdn2d"] == 0, (counts, want_w)
                calls = rec.unique()
            assert "Best test loss" in log, log
            recs = read_jsonl(f"concept2clip_{C2C_EPOCHS}.jsonl")
            assert len(recs) == C2C_EPOCHS and all(set(r) == C2C_KEYS for r in recs), recs
            assert all(np.isfinite(v) for r in recs for v in r.values()), recs
            run["records"] = recs
            params = ckpt.restore_pytree(f"c2c-{latent}")
            held = module_to_jax_tree(concept2clip_from_params(params, "cuda"))["params"]
            assert_trees_equal(held, params)
            _quiet_main(["port-weights", "export-concept2clip", f"c2c-{latent}", f"{latent}.pth"])
            sd = {k: v.numpy() for k, v in torch.load(f"{latent}.pth", weights_only=True).items()}
            assert sorted(sd) == [f"model.{i}.{n}" for i in (0, 2, 4) for n in ("bias", "weight")]
            assert_trees_equal(porting.convert_torch_concept2clip(sd), params)
            out[latent] = run
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    # One epoch card vs CPU from the cached spaces and embeddings.
    with np.load(TS._cache_path("checkpoints/concepts", "synthetic", datasets[0])) as f:
        spaces = (f["train"], f["test"])
    embs = tuple(np.load(f"checkpoints/clip/ViT-B-32_synthetic_img_{s}.npz")["emb"]
                 for s in ("train", "test"))
    seed_model = init_models(Concept2CLIP(n_concepts=N_CONCEPTS, device="cpu"), SEED + 116)
    set_tf32(False)
    on_cpu = c2c_epoch(spaces, embs, "cpu", seed_model, "c2c_cpu.jsonl")
    on_card = c2c_epoch(spaces, embs, "cuda", seed_model, "c2c_card.jsonl")
    dev, same = c2c_deviation(on_card, on_cpu)
    assert dev <= C2C_RTOL and same, (on_card, on_cpu)
    with UnshuffledTestLoader():
        faulty = c2c_epoch(spaces, embs, "cuda", seed_model, "c2c_fault.jsonl")
    fault_dev, fault_same = c2c_deviation(faulty, on_cpu)
    assert fault_dev > C2C_RTOL or not fault_same, (faulty, on_cpu)
    tf32_defaults(device)
    out["card_vs_cpu"] = {"deviation": dev, "card": on_card, "cpu": on_cpu,
                          "fault_deviation": fault_dev, "fault_matching_equal": fault_same}
    w = {k: out[lt]["walls"][k][0] for lt, k in (("viscoin", "clip_pass"),
                                                 ("viscoin", "concept_pass"),
                                                 ("gan", "w_pass"))}
    epochs = {lt: out[lt]["epochs"] for lt in ("viscoin", "gan")}
    out["walls"] = {**w, **{f"epochs_{lt}": e for lt, e in epochs.items()}}
    ms = {lt: ", ".join(f"{1e3 * t:.1f}" for t in e) for lt, e in epochs.items()}
    say("concept2clip", f"(c) train concept2clip --dataset synthetic --epochs {C2C_EPOCHS} "
        f"({C2C_N} + {C2C_N} images at {RES}², the flagship bundle): --latent-type viscoin "
        f"{out['viscoin']['s']:.1f} s, launches none; gan {out['gan']['s']:.1f} s, launches "
        f"{out['gan']['launches']}, exactly the W+ pass's count on the CPU at narrow widths, no "
        f"upfirdn2d; jsonl keys {sorted(C2C_KEYS)}, finite; checkpoints reloaded and "
        "exported (model.0/2/4) and back bit-equal; walls: the CLIP pass over "
        f"{2 * C2C_N} images {w['clip_pass']:.2f} s (host PIL preprocessing included), the "
        f"concept pass {w['concept_pass']:.2f} s, the W+ pass {w['w_pass']:.2f} s, the "
        f"epochs ({C2C_N // 32} steps of 32 and the test pass) {ms['viscoin']} ms "
        f"(concepts), {ms['gan']} ms (W+); {card}")
    say("concept2clip", f"(c) one epoch at batch {C2C_CHECK_BATCH} from the cached spaces, card "
        f"(TF32 off) vs CPU: losses within {dev:.3g} relative (tolerance {C2C_RTOL:g}), "
        f"matching accuracy equal ({on_card['matching_accuracy']:.4f}); the planted fault "
        f"(the test loader unshuffled) {fault_dev:.3g}, matching "
        f"{'equal' if fault_same else 'different'}: caught; {card}")
    return out, calls


def phase_concept2clip(bundle: str, device: dict) -> tuple[dict, dict]:
    """(a)-(c) in a directory of their own beside the analysis phase's bundle
    (the analysis phase's W+ cache there is of other images). Returns
    (record, {label: the W+ pass's kernel calls})."""
    out: dict = {}
    t_start = time.perf_counter()
    cwd = os.getcwd()
    work = os.path.join(os.path.dirname(bundle), "concept2clip")
    os.makedirs(work)
    os.chdir(work)
    try:
        out["clip"] = c2c_clip(device)
        torch.cuda.empty_cache()
        out["port_weights"] = c2c_port_weights(device)
        torch.cuda.empty_cache()
        out["command"], calls = c2c_command(bundle, device)
    finally:
        os.chdir(cwd)
        tf32_defaults(device)
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_start
    say("concept2clip", f"the phase took {out['seconds']:.1f} s; {device['nvidia_smi']}")
    return out, {"train concept2clip --latent-type gan": calls}


# ------------------------------- the dp phase --------------------------------- #

DP_N = 20  # synthetic images per split for (a): the loop phase's 20 test images
DP_LOSS_TOL = 1e-4  # two ranks against one process, both on the card (TF32 off): relative
# The Adams' first moments (the averaged gradients) of each network (Psi,
# Theta and the mapping; G; D), ||difference|| / ||one process's||. Not each
# leaf's largest element: a pre-activation within rounding of lrelu's kink
# takes the other slope in one of the runs, and a scalar leaf (a noise
# strength, a sum over a whole batch of feature maps) whose gradient nearly
# cancels moves by up to 0.6 of itself on an H100 (reported, not held).
DP_GRAD_TOL = 1e-3
# Adam's first update is lr * g / (|g| + eps) per element whatever g's size,
# so an element whose gradient lies within rounding of 0 may step the other
# way (2 % of the VisCoIN step's elements on an H100): the parameters
# after the update are held to 2 lr everywhere and to 1 % of lr where the two
# runs' gradients agree within 1 %.
DP_UPDATE_TOL = 0.01


def _gloo_env() -> dict:
    """Loopback for the collectives' sockets: one host, no network."""
    env = pipe_env()
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    return env


def _torchrun(nproc: int, args: list[str]) -> list[str]:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
            str(nproc), str(Path(__file__).resolve()), *args]


def run_groups(cmds: dict[str, tuple[list[str], str]], timeout: float = 900,
               env: dict | None = None) -> dict[str, tuple[float, str]]:
    """Each ``label: (cmd, cwd)`` in a session of its own (torchrun and its
    workers), all started at once, ``env`` added to their environment; on a
    timeout or a failure every session is killed. Returns {label: (wall s,
    output)}; raises on a non-zero exit."""
    return Groups(cmds, env).collect(timeout)


class Groups:
    """Each ``label: (cmd, cwd)`` started at once in a session of its own
    (torchrun and its workers), ``env`` added to their environment;
    :meth:`collect` waits for them. On a timeout, a failure or an exit of
    the ``with`` block first, every session is killed."""

    def __init__(self, cmds: dict[str, tuple[list[str], str]], env: dict | None = None):
        self.cmds, self.t0, self.done = cmds, time.perf_counter(), None
        self.procs = {label: subprocess.Popen(cmd, cwd=cwd, env={**_gloo_env(), **(env or {})},
                                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                              text=True, start_new_session=True)
                      for label, (cmd, cwd) in cmds.items()}

    def collect(self, timeout: float = 900) -> dict[str, tuple[float, str]]:
        """{label: (wall s since the start, output)}; raises on a non-zero
        exit. A second call returns the first's result."""
        if self.done is not None:
            return self.done
        out = {}
        # A session that has failed already first: its output names the cause,
        # while one before it in the order may wait (the mp ranks at their pause).
        failed_first = sorted(self.procs.items(), key=lambda kv: kv[1].poll() in (None, 0))
        try:
            for label, proc in failed_first:
                left = max(1.0, timeout - (time.perf_counter() - self.t0))
                try:
                    log, _ = proc.communicate(timeout=left)
                except subprocess.TimeoutExpired:
                    raise RuntimeError(f"{label} timed out after {timeout} s") from None
                if proc.returncode != 0:
                    # Each rank's last error line too: a torchrun log ends with
                    # the ranks that died of the first one's failure.
                    errors = [ln for ln in log.splitlines() if "Error" in ln][-12:]
                    raise RuntimeError(f"{label}: {' '.join(self.cmds[label][0][2:8])} ... "
                                       f"exited {proc.returncode}:\n{log[-6000:]}\nerror lines:\n"
                                       + "\n".join(ln[:600] for ln in errors))
                out[label] = (time.perf_counter() - self.t0, log)
        finally:
            self.kill()
        self.done = out
        return out

    def kill(self) -> None:
        import signal

        for proc in self.procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate(timeout=60)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.kill()


def dp_command_main(out_path: str, argv: list[str]) -> int:
    """`python chip_smoke.py --dp-command OUT -- <argv>`: the command
    ``python -m viscoin_tpu_torch <argv>`` in this process (under torchrun,
    one of its ranks) with cuDNN's deterministic algorithms on; then its
    exit code, the meshes it joined (world size, backend), the kernel
    launches and the peak memory, as JSON in OUT."""
    from viscoin_tpu_torch.parallel import mesh as M

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    meshes = []
    make_mesh = M.make_mesh

    def recording(*args, **kw):  # the command's own make_mesh, observed
        mesh = make_mesh(*args, **kw)
        meshes.append((mesh.world, torch.distributed.get_backend()))
        return mesh

    M.make_mesh = recording
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = _port_main(argv)
    with open(out_path, "w") as f:
        json.dump({"rc": rc, "meshes": meshes, "seconds": time.perf_counter() - t0,
                   "launches": _kernels.launch_counts(),
                   "peak_mb": torch.cuda.max_memory_allocated() / 2**20}, f)
    return rc


def dp_command(card: str, shared: bool = False) -> dict:
    """(a) `train viscoin` at flagship width on DP_N synthetic images (batch
    8, 4 iterations, eval every 2, checkpoints at 0 and 3) under `torchrun
    --standalone --nproc-per-node 1` (the mesh branches through NCCL at
    world size 1) against the same command with --no-data-parallel, from
    the same seeds: the jsonl records and every tensor of the training state
    after step 4 bit-equal; the launches of the whole command equal."""
    args = ["train", "viscoin", "--dataset", "synthetic", "--batch-size", str(BATCH),
            "--epochs", "4", "--eval-every", "2", "--checkpoint-every", "3",
            "--faithfulness-every", "0"]
    out: dict = {}
    dirs = {label: tempfile.mkdtemp(prefix=f"viscoin_dp_{label}_")
            for label in ("torchrun", "no_dp")}
    try:
        # Both at once on the card (each in its own process, under cuDNN's
        # deterministic algorithms): the comparison does not depend on timing.
        result = {label: os.path.join(d, "result.json") for label, d in dirs.items()}
        runs = run_groups({
            "torchrun": (_torchrun(1, ["--dp-command", result["torchrun"], "--", *args]),
                         dirs["torchrun"]),
            "no_dp": ([sys.executable, str(Path(__file__).resolve()), "--dp-command",
                       result["no_dp"], "--", *args, "--no-data-parallel"], dirs["no_dp"])},
            env={"VISCOIN_SYNTH_N": str(DP_N)})
        out["wall_s"] = max(wall for wall, _ in runs.values())
        for label, path in result.items():
            with open(path) as f:
                res = json.load(f)
            assert res["rc"] == 0, res
            out[label] = res
        assert out["torchrun"]["meshes"] == [[1, "nccl"]], out["torchrun"]["meshes"]
        assert out["no_dp"]["meshes"] == [], out["no_dp"]["meshes"]
        recs = {k: read_jsonl(os.path.join(d, "viscoin_4.jsonl")) for k, d in dirs.items()}
        check_records(recs["torchrun"], 2, "dp")
        out["records_equal"] = recs["torchrun"] == recs["no_dp"]
        states = {k: torch.load(os.path.join(d, "train_state", "train_state.pt"),
                                weights_only=True) for k, d in dirs.items()}
        assert states["torchrun"]["step"] == 4, states["torchrun"]["step"]
        dev = tree_deviation(states["torchrun"], states["no_dp"])
        out["state_tensors"] = len(dev)
        out["state_max_dev"] = max(dev.values())
        out["launches_equal"] = out["torchrun"]["launches"] == out["no_dp"]["launches"]
        assert out["records_equal"], (recs["torchrun"], recs["no_dp"])
        assert out["state_max_dev"] == 0.0, sorted(dev.items(), key=lambda kv: -kv[1])[:5]
        assert out["launches_equal"], (out["torchrun"]["launches"], out["no_dp"]["launches"])
    finally:
        for d in dirs.values():
            shutil.rmtree(d, ignore_errors=True)
    say("dp", f"(a) `torchrun --standalone --nproc-per-node 1 chip_smoke.py --dp-command` = "
        f"`python -m viscoin_tpu_torch {' '.join(args)}` on {DP_N} synthetic images at 256², "
        f"full width (the mesh branches through NCCL at world size 1), and beside it on the "
        f"card the same with --no-data-parallel"
        + (" (and the mp phase's three processes and the rest of the pipeline lane: walls "
           "and peaks under contention, not comparable with runs that have the card alone)"
           if shared else "")
        + f": {out['wall_s']:.1f} s wall for both (the "
        f"commands themselves {out['torchrun']['seconds']:.1f} s and "
        f"{out['no_dp']['seconds']:.1f} s), peak "
        f"{out['torchrun']['peak_mb']:.0f} and {out['no_dp']['peak_mb']:.0f} MiB; both jsonl "
        f"records bit-equal, all "
        f"{out['state_tensors']} tensors of the training state after step 4 bit-equal; "
        f"launches of the whole command {out['torchrun']['launches']} in both; {card}")
    return out


def _const_noise(module) -> None:
    """The synthesis of ``module`` runs with its constant noise buffers
    whatever noise mode its caller asks for (each rank of several and one
    process then see the same noise per sample)."""
    synthesis = module.synthesis
    forward = type(synthesis).forward

    def const(ws, *args, **kw):
        kw.pop("generator", None)
        kw["noise_mode"] = "const"
        return forward(synthesis, ws, *args, **kw)

    synthesis.forward = const


def _rows(x, mesh):
    return x if mesh is None else x[mesh.rows(mesh.local(x.shape[0]))]


def dp_viscoin_inputs() -> dict:
    """The global VisCoIN batch of (b): 8 real images (preprocessed, fp32)
    and labels, 8 synthetic ones, the explainer's keep mask, all seeded on
    the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 100)
    real = device_preprocess(torch.from_numpy(seeded_images(BATCH, SEED + 101)).cuda())
    return dict(real=real, labels=torch.from_numpy(np.random.default_rng(SEED + 102).integers(
        0, N_CLASSES, BATCH)).cuda(), fake=torch.randn((BATCH, 3, RES, RES), device="cuda",
                                                       generator=gen),
        mask=torch.rand((2 * BATCH, N_CONCEPTS, 3, 3), device="cuda", generator=gen) < 0.8)


def dp_viscoin_step(models, lpips, inp: dict, mesh, fault: bool = False) -> dict:
    """One fp32 VisCoIN step past the warm-up gate on a copy of ``models``
    (constant synthesis noise; each rank its rows of ``inp``, the mask's
    real rows then its synthetic ones): the global metrics, the updated
    trainable parameters, the Adams' first moments, the launches.
    ``fault``: a planted fault, the gradients not averaged over the ranks."""
    from viscoin_tpu_torch.parallel import mesh as M

    models = copy.deepcopy(models)
    _const_noise(models.gan)
    cfg = T.VisCoINTrainingParams(batch_size=BATCH, compute_dtype="float32")
    frozen = T.make_frozen(models, None, lpips, "float32")
    state = T.create_train_state(models, cfg)
    state.step = cfg.cd_fid_iteration + 1  # all six loss terms live
    step = T.make_train_step(models, None, lpips, cfg, preprocess=False, external_fakes=True,
                             mesh=mesh)
    mask = torch.cat([_rows(inp["mask"][:BATCH], mesh), _rows(inp["mask"][BATCH:], mesh)])
    orig = M.all_reduce_grads
    if fault:
        T.all_reduce_grads = lambda grads, mesh: grads
    try:
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        _, metrics = step(state, frozen, _rows(inp["real"], mesh), _rows(inp["labels"], mesh),
                          torch.Generator(device="cuda").manual_seed(0),
                          _rows(inp["fake"], mesh), dropout_mask=mask)
        torch.cuda.synchronize()
        launches = _kernels.launch_counts()
    finally:
        T.all_reduce_grads = orig
    after = {f"{g}.{n}": p.detach().clone() for g, grp in state.params.items()
             for n, p in grp.items()}
    moments = {f"{g}.{n}": opt.state[p]["exp_avg"].clone() for opt in (state.opt, state.gan_opt)
               for g, grp in state.params.items() for n, p in grp.items() if p in opt.state}
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "after": after,
            "exp_avg": moments, "launches": launches, "lr": cfg.learning_rate}


def dp_gan_steps(g, d, mesh, fault: bool = False) -> list[dict]:
    """One GAN step of each cadence type (GAN_CADENCES), each from a fresh
    state on copies of ``g`` and ``d`` (fp32, ada_p GAN_ADA_P, constant
    synthesis noise; a step's Adam moves every element by about lr, so a
    sequence would carry the rare element stepping the other way into the
    next step's losses) on the global batch of GAN_BATCH seeded images,
    each rank its rows and its rows of the global draws. Per step: the
    metrics, the launches, G, D and the EMA after the update, both Adams'
    first moments (beta1 = 0: the averaged gradients), w_avg, pl_mean and
    the ADA state. ``fault``: the gradients not averaged over the ranks."""
    from viscoin_tpu_torch.parallel import mesh as M

    images = torch.from_numpy(seeded_images(GAN_BATCH, GAN_SEED + 4)).cuda()
    out = []
    orig = M.all_reduce_grads
    if fault:
        TG.all_reduce_grads = lambda grads, mesh: grads
    try:
        for label, i, kw in GAN_CADENCES:
            gc, dc = copy.deepcopy(g), copy.deepcopy(d)
            _const_noise(gc)
            cfg = TG.GANTrainingParams(compute_dtype="float32", augment_p=GAN_ADA_P,
                                       batch_size=GAN_BATCH, **kw)
            state = TG.create_gan_train_state(gc, dc, cfg)
            # G holds still (its Adam at lr 0, its moments still taken): an
            # element of G that steps the other way in one run would move the
            # D phase's fakes, and so D's gradients, more than rounding does.
            for group in state.g_opt.param_groups:
                group["lr"] = 0.0
            step = TG.make_gan_train_step(gc, dc, cfg, mesh)
            state.step = i
            draws = TG.draw_step(cfg, gc, GAN_SEED, i, "cuda", mesh)
            torch.cuda.synchronize()
            _kernels.reset_launch_counts()
            _, metrics = step(state, _rows(images, mesh), draws)
            torch.cuda.synchronize()
            res = {"label": label, "launches": _kernels.launch_counts(),
                   "metrics": {k: float(v) for k, v in metrics.items()}, "lr": cfg.learning_rate,
                   "params": {f"{who}.{n}": p.detach().clone() for who, module in
                              (("G", gc), ("D", dc), ("EMA", state.g_ema))
                              for n, p in module.named_parameters()},
                   "exp_avg": {f"{who}.{n}": opt.state[p]["exp_avg"].clone()
                               for who, module, opt in (("G", gc, state.g_opt),
                                                        ("D", dc, state.d_opt))
                               for n, p in module.named_parameters()},
                   "w_avg": state.w_avg.clone(), "pl_mean": float(state.pl_mean),
                   "ada_p": float(state.ada_p), "ada_rt": float(state.ada_rt)}
            out.append(res)
            del gc, dc, state, step
    finally:
        TG.all_reduce_grads = orig
    return out


def _moment_dev(got: dict, want: dict) -> dict:
    """First moments against one process's: per network (the leaves' first
    name part), ||got - want|| / ||want||; and the leaf with the largest
    |got - want| / max |want|, reported."""
    nets: dict[str, list] = {}
    for k, w in want.items():
        acc = nets.setdefault(k.split(".")[0], [0.0, 0.0])
        acc[0] += float((got[k] - w).double().square().sum())
        acc[1] += float(w.double().square().sum())
    leaf = max((float((got[k] - w).abs().max()) / max(float(w.abs().max()), 1e-30), k)
               for k, w in want.items())
    return {"nets": {n: math.sqrt(d / max(t, 1e-60)) for n, (d, t) in nets.items()},
            "leaf": leaf}


def _update_dev(got: dict, want: dict, got_m: dict, want_m: dict, lr: float) -> list[float]:
    """Parameters after the update against one process's: [the largest
    difference / lr, the largest / lr where the two runs' gradients (the
    first moments) agree within 1 %, the share of elements where they do].
    Two fp32 roundings of each parameter (2 * 2^-23 of its size; 0.15 lr at
    128 and lr 1e-4) are taken off each difference first."""
    worst = agree_worst = 0.0
    agree_n = total = 0
    for k, g in want_m.items():
        diff = ((got[k] - want[k]).abs() - 2.0**-22 * want[k].abs()).clamp_min(0.0) / lr
        worst = max(worst, float(diff.max()))
        agree = (got_m[k] - g).abs() <= 0.01 * g.abs()
        if bool(agree.any()):
            agree_worst = max(agree_worst, float(diff[agree].max()))
        agree_n += int(agree.sum())
        total += g.numel()
    return [worst, agree_worst, agree_n / total]


def dp_worker_main(out_dir: str) -> int:
    """`torchrun --nproc-per-node 2 chip_smoke.py --dp-worker DIR`: one of two
    ranks on the one card over gloo with CUDA tensors (NCCL refuses two
    ranks on one card). Each builds the flagship bundle, LPIPS and the GAN
    from the seeds, runs the VisCoIN step and the GAN steps over the mesh
    (and again with a planted fault); rank 0 then runs both in one process
    on the global batch and compares. Writes rank<r>.json to DIR."""
    from viscoin_tpu_torch.parallel import mesh as M

    mesh = M.make_mesh("cuda:0", backend="gloo")
    set_tf32(False)
    t0 = time.perf_counter()
    rec: dict = {"rank": mesh.rank, "world": mesh.world}
    models = default_models(N_CLASSES, N_CONCEPTS, RES, CHANNEL_BASE, CHANNEL_MAX, device="cuda",
                            seed=SEED)
    perturb_constants(models, SEED + 10)
    _, lpips = train_modules()
    g_gan, d_gan = gan_modules()
    inp = dp_viscoin_inputs()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    vis = dp_viscoin_step(models, lpips, inp, mesh)
    vis_fault = dp_viscoin_step(models, lpips, inp, mesh, fault=True)
    rec["viscoin_s"] = time.perf_counter() - t
    t = time.perf_counter()
    gan = dp_gan_steps(g_gan, d_gan, mesh)
    gan_fault = dp_gan_steps(g_gan, d_gan, mesh, fault=True)
    rec["gan_s"] = time.perf_counter() - t
    rec["peak_mb"] = torch.cuda.max_memory_allocated() / 2**20
    rec["launches"] = {"viscoin": vis["launches"], "gan": [s["launches"] for s in gan]}
    # The ranks hold the same parameters: every tensor's float64 sum, gathered.
    sums = torch.stack([t.double().sum() for t in (*vis["after"].values(),
                                                   *(p for s in gan
                                                     for p in s["params"].values()))])
    gathered = M.all_gather_batch(sums[None], mesh)
    rec["ranks_equal"] = bool((gathered == gathered[0]).all())
    if mesh.rank == 0:
        ref = dp_viscoin_step(models, lpips, inp, None)
        rec["viscoin"] = {
            "metrics": {k: abs(v - ref["metrics"][k]) / max(abs(ref["metrics"][k]), 1e-6)
                        for k, v in vis["metrics"].items()},
            "exp_avg": _moment_dev(vis["exp_avg"], ref["exp_avg"]),
            "fault_exp_avg": _moment_dev(vis_fault["exp_avg"], ref["exp_avg"]),
            "update": _update_dev(vis["after"], ref["after"], vis["exp_avg"], ref["exp_avg"],
                                  vis["lr"]),
            "launches_ref": ref["launches"]}
        gref = dp_gan_steps(g_gan, d_gan, None)
        rec["gan"] = [{
            "label": m["label"],
            "metrics": {k: abs(v - w["metrics"][k]) / max(abs(w["metrics"][k]), 1e-6)
                        for k, v in m["metrics"].items()},
            "rt": (m["metrics"]["ada_rt"], w["metrics"]["ada_rt"]),
            "exp_avg": _moment_dev(m["exp_avg"], w["exp_avg"]),
            "fault_exp_avg": _moment_dev(f["exp_avg"], w["exp_avg"]),
            "update": _update_dev(m["params"], w["params"], m["exp_avg"], w["exp_avg"],
                                  m["lr"]),
            "w_avg": float((m["w_avg"] - w["w_avg"]).abs().max() / w["w_avg"].abs().max()),
            "pl_mean": abs(m["pl_mean"] - w["pl_mean"]) / max(abs(w["pl_mean"]), 1e-6),
            "ada_p": (m["ada_p"], w["ada_p"]),
            "launches_ref": w["launches"]} for m, f, w in zip(gan, gan_fault, gref)]
    rec["seconds"] = time.perf_counter() - t0
    M.barrier(mesh)
    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(rec, f)
    M.destroy_mesh(mesh)
    return 0


def dp_gloo(card: str) -> dict:
    """(b) two processes on the one card over gloo with CUDA tensors: the
    VisCoIN step at the global batch 8 + 8 and the GAN step of every cadence
    type (each from the same state) at the global batch 16, each split 2
    ways, against one process at
    the same global batch (the synthetic batch, the explainer's mask and the
    GAN draws given, constant synthesis noise): every loss and metric, the
    averaged gradients (the Adams' first moments), the updated parameters,
    w_avg, pl_mean, r_t and ada_p; each rank's launches those of the
    one-process step (a step launches each kernel once per layer, whatever
    its batch); a planted fault (the gradient all-reduce skipped) must fail
    the moments' check."""
    work = tempfile.mkdtemp(prefix="viscoin_dp_gloo_")
    try:
        wall, _ = run_groups({"gloo": (_torchrun(2, ["--dp-worker", work]), work)})["gloo"]
        ranks = []
        for r in range(2):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    r0 = ranks[0]
    vis, gan = r0["viscoin"], r0["gan"]
    out = {"wall_s": wall, "ranks": ranks}
    worst = {"viscoin metrics": max(vis["metrics"].values()),
             **{f"gan {s['label']} {k}": v for s in gan for k, v in s["metrics"].items()
                if k != "ada_rt"},
             **{f"gan {s['label']} w_avg": s["w_avg"] for s in gan},
             **{f"gan {s['label']} pl_mean": s["pl_mean"] for s in gan}}
    parts = {"viscoin": vis, **{f"gan {s['label']}": s for s in gan}}
    moments = {f"{k} {n}": v for k, part in parts.items()
               for n, v in part["exp_avg"]["nets"].items()}
    leaves = {k: part["exp_avg"]["leaf"] for k, part in parts.items()}
    # The planted fault must fail the first moments' check in every comparison.
    faults = {k: max(part["fault_exp_avg"]["nets"].values()) for k, part in parts.items()}
    updates = {"viscoin": vis["update"], **{f"gan {s['label']}": s["update"] for s in gan}}
    out.update(worst=worst, moments=moments, moment_leaves=leaves, faults=faults,
               updates=updates)
    say("dp", "(b) deviations from one process: " + ", ".join(
        f"{k} {v:.3g}" for k, v in worst.items()) + "; r_t " + str([s["rt"] for s in gan])
        + "; first moments " + ", ".join(f"{k} {v:.3g}" for k, v in moments.items())
        + "; the leaf furthest off (reported) " + ", ".join(
            f"{k} {v[0]:.3g} {v[1]}" for k, v in leaves.items())
        + "; parameters after the update (worst / lr, worst / lr where the gradients agree "
          "within 1 %, that share) " + ", ".join(f"{k} {v[0]:.3g} {v[1]:.3g} {v[2]:.3g}"
                                                 for k, v in updates.items())
        + "; planted fault, first moments " + ", ".join(f"{k} {v:.3g}" for k, v in faults.items()))
    assert all(r["ranks_equal"] for r in ranks), "the ranks' parameters differ"
    for r in ranks:
        assert r["launches"]["viscoin"] == vis["launches_ref"], (r["rank"], r["launches"])
        assert r["launches"]["gan"] == [s["launches_ref"] for s in gan], (r["rank"],
                                                                           r["launches"])
    for k, v in worst.items():
        assert v <= DP_LOSS_TOL, (k, v)
    # r_t is a mean of signs: one logit's sign across 0 moves it by 2 / 16.
    assert all(abs(a - b) <= 2 / GAN_BATCH for a, b in (s["rt"] for s in gan)), gan
    assert all(s["ada_p"][0] == s["ada_p"][1] for s in gan), gan
    for k in moments:
        assert moments[k] <= DP_GRAD_TOL, (k, moments[k])
    for k in updates:
        assert updates[k][0] <= 2.0 + DP_UPDATE_TOL and updates[k][1] <= DP_UPDATE_TOL, \
            (k, updates[k])
    assert min(faults.values()) > DP_GRAD_TOL, faults
    say("dp", f"(b) `torchrun --standalone --nproc-per-node 2 chip_smoke.py --dp-worker`: two "
        f"ranks on the one card over gloo with CUDA tensors, {wall:.1f} s wall (rank 0: "
        f"VisCoIN {r0['viscoin_s']:.1f} s, GAN {r0['gan_s']:.1f} s, each with its planted "
        f"fault; per rank wall and peak " + ", ".join(
            f"rank {r['rank']} {r['seconds']:.1f} s {r['peak_mb']:.0f} MiB" for r in ranks)
        + f"); against one process at the same global batch every check passed: metrics "
        f"within {DP_LOSS_TOL:g} (r_t within one sign), first moments within {DP_GRAD_TOL:g} "
        f"of each network's norm, the parameters after the update within 2 lr and within "
        f"{DP_UPDATE_TOL:g} lr where the gradients agree within 1 % (G held still in the "
        f"GAN's), "
        f"launches per rank those of one process, the ranks' parameters equal; the "
        f"planted fault (no gradient all-reduce) fails it: first moments off by at least "
        f"{min(faults.values()):.3g}; {card}")
    return out


def dp_serve(models, card: str) -> dict:
    """(c) `serve --data-parallel` (its engine, built by the command on the
    one visible card: one replica) against InferenceEngine(device="cuda"):
    classify, reconstruct and explain on 10 images bit-equal."""
    from viscoin_tpu_torch.utils.cudnn import deterministic_cudnn
    from viscoin_tpu_torch.serve import server

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="viscoin_dp_serve_")
    seen = []
    orig = server.run_server
    server.run_server = lambda engine, **kw: seen.append(engine)
    try:
        bundle = os.path.join(tmp, "viscoin-flagship")
        ckpt.save_viscoin(models, bundle)
        assert _port_main(["serve", "--viscoin-pickle-path", bundle, "--data-parallel",
                           "--compute-dtype", "float32", "--port", "0"]) == 0
    finally:
        server.run_server = orig
        shutil.rmtree(tmp, ignore_errors=True)
    (dp_engine,) = seen
    assert [d for d, _ in dp_engine.replicas] == [torch.device("cuda", 0)]
    engine = InferenceEngine(models, batch_size=BATCH, compute_dtype="float32", device="cuda")
    imgs = seeded_images(10, SEED + 110)
    # Under cuDNN's deterministic algorithms: the up-convs' transposed
    # convolutions add with atomics by default (1 u8 level apart on an H100).
    with deterministic_cudnn():
        for endpoint in ("classify", "reconstruct", "explain"):
            got, want = getattr(dp_engine, endpoint)(imgs), getattr(engine, endpoint)(imgs)
            for k in want:
                assert np.array_equal(got[k], want[k]), (endpoint, k)
    out = {"seconds": time.perf_counter() - t0,
           "peak_mb": torch.cuda.max_memory_allocated() / 2**20}
    del dp_engine, engine
    say("dp", f"(c) `serve --data-parallel` on the one visible card (one replica, on cuda:0): "
        f"classify, reconstruct and explain on 10 images bit-equal to InferenceEngine("
        f"device='cuda') under cuDNN's deterministic algorithms; {out['seconds']:.1f} s, peak "
        f"{out['peak_mb']:.0f} MiB; {card}")
    return out


def phase_dp(models, device: dict, beside: Groups | None = None) -> dict:
    """Data parallelism (parallel/mesh.py): (a), (b) and (c) above.
    ``beside``: processes started before (a) that run beside it (the mp
    phase's), collected after it, before (b) takes the card's memory."""
    card = device["nvidia_smi"]
    t0 = time.perf_counter()
    out = {"command": dp_command(card, shared=beside is not None)}
    if beside is not None:
        beside.collect(timeout=MP_PAUSE_S)
    torch.cuda.empty_cache()
    out["gloo"] = dp_gloo(card)
    set_tf32(False)
    out["serve"] = dp_serve(models, card)
    tf32_defaults(device)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    say("dp", f"the phase took {out['seconds']:.1f} s; {card}")
    return out


# ----------------------------- model parallelism ----------------------------- #

MP_LOSS_TOL = 1e-4  # the (1, 2) mesh's step against one process, fp32, TF32 off: relative
# Each network's gradient (Psi, Theta, the mapping: the Adams' first moments
# / (1 - beta1)), ||difference|| / ||one process's||, as the dp phase holds.
MP_GRAD_TOL = 1e-3
MP_BF16_TOL = 2e-2  # bf16: every metric of the 2-D step against one process's bf16 step
MP_PEAK_RATIO = 0.8  # each rank's peak memory against one process's at the same global batch
# The mp processes start after the kernel checks and take their peaks with no
# other process on the card (the main process runs its first phases, and waits for
# the peaks before it starts the lanes), then idle until dp's (a): in fp32
# with TF32 off, cuDNN's first choice for
# LPIPS's 128-channel 3x3 convolutions at 128² takes a workspace of several
# GiB, as large on a rank's rows as on the whole plane, which it passes over
# when other processes leave the card short of memory, so beside them the
# peaks would follow the run's concurrency.
MP_MEMORY_WAIT_S = 420
MP_PAUSE_S = 1200
MP_LOOP_N = 16  # synthetic train images of the mp loop (two global batches); 8 test images
# The GAN step over the (1, 2) mesh against one process (fp32, TF32 off, cuDNN's
# deterministic algorithms, under which one process is bit-equal to itself): the
# metrics (relative) and each network's gradient (of its norm) held at the dp
# phase's bounds for the same comparison and reported against the targets
# beside the card's floor (one process against itself under cuDNN's default
# algorithms); the planted fault must move some metric by more than
# MP_GAN_FAULT_MIN.
MP_GAN_LOSS_TOL, MP_GAN_GRAD_TOL, MP_GAN_FAULT_MIN, MP_GAN_BF16_TOL = (DP_LOSS_TOL, DP_GRAD_TOL,
                                                                        1e-2, 1e-2)
MP_GAN_LOSS_TARGET, MP_GAN_GRAD_TARGET = 1e-5, 1e-4
MP_GAN_STEPS = (("r1+ppl", 0), ("plain", 1))  # (label, step): R1 and the path length at 0
MP_GAN_N = 32  # synthetic images of `train gan --model-parallel 2` (two global batches)


def mp_step(models, lpips, inp: dict, mesh, dtype: str, fault: bool = False) -> dict:
    """One VisCoIN step past the warm-up gate on a copy of ``models``
    (constant synthesis noise, the synthetic batch and the explainer's mask
    given) over the (1, 2) ``mesh`` (this rank's H rows of every image) or,
    without one, in one process: the metrics, each trainable leaf's gradient
    (from the Adams' first moments) and value after the update, the kernel
    launches and the spatial collectives, counted from 0 just before the
    step. ``fault``: a planted fault, every halo filled with zeros."""
    from viscoin_tpu_torch.parallel import spatial as S

    models = copy.deepcopy(models)
    _const_noise(models.gan)
    cfg = T.VisCoINTrainingParams(batch_size=BATCH, compute_dtype=dtype)
    frozen = T.make_frozen(models, None, lpips, dtype)
    state = T.create_train_state(models, cfg)
    state.step = cfg.cd_fid_iteration + 1  # all six loss terms live
    step = T.make_train_step(models, None, lpips, cfg, preprocess=False, external_fakes=True,
                             mesh=mesh)
    rows = slice(None) if mesh is None else mesh.model_axis.rows(RES // mesh.model)
    halo = S.halo_exchange
    if fault:
        S.halo_exchange = lambda x, top, bottom, sp, fill=0.0: F.pad(x, (0, 0, top, bottom))
    try:
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        S.reset_counts()
        _, metrics = step(state, frozen, inp["real"][:, :, rows], inp["labels"],
                          torch.Generator(device="cuda").manual_seed(0),
                          inp["fake"][:, :, rows], dropout_mask=inp["mask"])
        torch.cuda.synchronize()
        launches, counts = _kernels.launch_counts(), S.counts()
    finally:
        S.halo_exchange = halo
    grads = {f"{g}.{n}": (opt.state[p]["exp_avg"] / 0.1).cpu()
             for opt in (state.opt, state.gan_opt) for g, grp in state.params.items()
             for n, p in grp.items() if p in opt.state}
    after = {f"{g}.{n}": p.detach().cpu() for g, grp in state.params.items()
             for n, p in grp.items()}
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
            "after": after, "launches": launches, "counts": counts}


def mp_loop(models, gen, lpips, mesh, work: str) -> dict:
    """`train_viscoin` over the (1, 2) mesh at flagship width, fp32, under
    cuDNN's deterministic algorithms: run A, 4 iterations (eval every 2,
    checkpoints at 0 and 2, written by rank 0); run B, resumed from A's
    training state of step 3 to 4, on every rank. Each rank runs in a
    directory of its own. Returns both runs' trainable parameters, launches
    and files; rank 0's jsonl records."""
    from viscoin_tpu_torch.parallel import mesh as M

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    out: dict = {}
    resume = os.path.join(work, "rank0", "A", "train_state")  # what rank 0 wrote
    for label, kw in (("A", {}), ("B", {"resume_from": resume})):
        d = os.path.join(work, f"rank{mesh.rank}", label)
        os.makedirs(d, exist_ok=True)
        m = copy.deepcopy(models)
        train_ds = SyntheticDataset(n=MP_LOOP_N, n_classes=N_CLASSES, image_size=RES,
                                    mode="train")
        test_ds = SyntheticDataset(n=BATCH, n_classes=N_CLASSES, image_size=RES, mode="test")
        data = mesh.data_axis
        tl = DataLoader(train_ds, BATCH, seed=SEED, num_threads=4, shard=(data.rank, data.world))
        el = DataLoader(test_ds, BATCH, shuffle=False, num_threads=4,
                        shard=(data.rank, data.world), pad_final=True)
        cfg = T.VisCoINTrainingParams(batch_size=BATCH, iterations=4)
        if M.is_main(mesh):
            configure_score_logging(os.path.join(d, "viscoin_4.jsonl"))
        M.barrier(mesh)
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        T.train_viscoin(m, gen, lpips, tl, el, cfg, mesh=mesh, seed=SEED, checkpoint_dir=d,
                        eval_every=2, checkpoint_every=2, faithfulness_every=0, prefetch=1,
                        device="cuda", **kw)
        torch.cuda.synchronize()
        out[label] = {"seconds": time.perf_counter() - t0, "launches": _kernels.launch_counts(),
                      "params": {f"{g}.{n}": p.detach().cpu() for g, mod in
                                 T.trainable_modules(m).items()
                                 for n, p in mod.named_parameters()},
                      "files": sorted(os.listdir(d))}
        if M.is_main(mesh):
            out[label]["records"] = read_jsonl(os.path.join(d, "viscoin_4.jsonl"))
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    return out


def mp_gan_steps(g, d, mesh, dtype: str, fault: bool = False, steps=MP_GAN_STEPS,
                 deterministic: bool = True) -> dict:
    """GAN steps ``steps`` ((label, step counter) each) at the JAX command's
    width, each from a fresh state on copies of ``g`` and ``d``, over the
    (1, 2) ``mesh`` (this rank's H rows of every image) or, without one, in
    one process: random synthesis noise and the draws from (GAN_SEED, step),
    which the two ranks of a model group share; ADA at GAN_ADA_P. G holds
    still (its Adam at lr 0, its moments still taken), as in dp_gan_steps:
    an element of G that steps the other way in one run would move the D
    phase's fakes, and so D's gradients, more than rounding does. Per step
    the metrics, G's and D's gradients (the Adams' first moments, beta1 =
    0), the kernel launches and the spatial collectives, counted from 0 just
    before the step. ``fault``: a planted fault, the path-length gradient
    left un-reduced over the model group. ``deterministic``: under cuDNN's
    deterministic algorithms (else its defaults, as a user trains)."""
    from viscoin_tpu_torch.parallel import spatial as S

    torch.backends.cudnn.deterministic = deterministic
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    images = torch.from_numpy(seeded_images(len(steps) * GAN_BATCH, GAN_SEED + 6)).cuda()
    rows = slice(None) if mesh is None else mesh.model_axis.rows(RES // mesh.model)
    whole = TG.whole_ws_grads
    if fault:
        TG.whole_ws_grads = lambda partial, sp: partial
    out: dict = {}
    try:
        for j, (label, i) in enumerate(steps):
            gc, dc = copy.deepcopy(g), copy.deepcopy(d)
            cfg = TG.GANTrainingParams(compute_dtype=dtype, augment_p=GAN_ADA_P,
                                       batch_size=GAN_BATCH)
            state = TG.create_gan_train_state(gc, dc, cfg)
            for group in state.g_opt.param_groups:
                group["lr"] = 0.0
            step = TG.make_gan_train_step(gc, dc, cfg, mesh)
            state.step = i
            draws = TG.draw_step(cfg, gc, GAN_SEED, i, "cuda", mesh)
            x = images[j * GAN_BATCH: (j + 1) * GAN_BATCH, rows]
            torch.cuda.synchronize()
            _kernels.reset_launch_counts()
            S.reset_counts()
            _, metrics = step(state, x, draws)
            torch.cuda.synchronize()
            out[label] = {"metrics": {k: float(v) for k, v in metrics.items()},
                          "launches": _kernels.launch_counts(), "counts": S.counts(),
                          "grads": {f"{who}.{n}": opt.state[p]["exp_avg"].cpu()
                                    for who, module, opt in (("G", gc, state.g_opt),
                                                             ("D", dc, state.d_opt))
                                    for n, p in module.named_parameters()}}
            del gc, dc, state, step
    finally:
        TG.whole_ws_grads = whole
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    return out


def phase_peaks(fn) -> tuple[list[float], float]:
    """Run ``fn`` with the peak memory taken after each gradient of a GAN
    step (G's, the path length's, D's: each over its forward and backward)
    and reset; returns those peaks (MiB) and the peak over the whole run."""
    peaks, grads = [], TG._grads

    def measured(loss, params):
        out = grads(loss, params)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() / 2**20)
        torch.cuda.reset_peak_memory_stats()
        return out

    TG._grads = measured
    try:
        fn()
    finally:
        TG._grads = grads
    torch.cuda.synchronize()
    return peaks, max(peaks + [torch.cuda.max_memory_allocated() / 2**20])


def mp_gan_peaks(mesh, defaults: tuple[bool, bool]) -> dict:
    """The GAN part of an mp process's work before the lanes start: the
    full-width G and D from their seeds; the R1 + path-length step at
    PyTorch's TF32 defaults and cuDNN's default algorithms, as a user trains,
    and its peak memory, overall and by phase (G's gradient, the path
    length's, D's with R1); then the two steps in fp32 with TF32 off (their
    kernel calls recorded) and their peak. Each starts with the caching
    allocator emptied: cuDNN's algorithm for a convolution, and so its
    workspace, follows the memory the process holds cached, so a peak taken
    after other work follows that work. ``defaults``: PyTorch's
    TF32 flags (cuDNN's, matmul's). The modules are freed after."""
    g, d = gan_modules()
    out: dict = {}

    def fresh():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    fresh()
    out["resident_mib"] = torch.cuda.memory_allocated() / 2**20
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = defaults
    out["phase_peaks_mib"], out["peak_mib"] = phase_peaks(lambda: mp_gan_steps(
        g, d, mesh, "float32", steps=MP_GAN_STEPS[:1], deterministic=False))
    set_tf32(False)
    fresh()
    with PathRecorder() as calls:
        out["float32"] = mp_gan_steps(g, d, mesh, "float32")
    out["calls"] = calls.unique()
    out["peak_tf32_off_mib"] = torch.cuda.max_memory_allocated() / 2**20
    del g, d
    torch.cuda.empty_cache()
    return out


def mp_gan_command(mesh, work: str) -> dict:
    """`python -m viscoin_tpu_torch train gan --data-parallel --model-parallel
    2` on MP_GAN_N synthetic 256² images (batch 16, its defaults otherwise),
    its options parsed by the command's parser and run by the command's
    `_train` on this process's (1, 2) mesh (the command would build the same
    mesh over NCCL, which takes one card per rank), under cuDNN's
    deterministic algorithms: run A, 2 iterations; run B, resumed from A's
    training state (what rank 0 wrote) to 4; run C, unbroken to 4. Each rank
    runs in directories of its own. Returns each run's seconds and launches,
    the files of each directory, and rank 0's training states of B and C."""
    from viscoin_tpu_torch.__main__ import build_parser
    from viscoin_tpu_torch.cli import train as cli_train
    from viscoin_tpu_torch.parallel import mesh as M

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    env = os.environ.get("VISCOIN_SYNTH_N")
    os.environ["VISCOIN_SYNTH_N"] = str(MP_GAN_N)
    base = ["train", "gan", "--dataset", "synthetic", "--batch-size", str(GAN_BATCH),
            "--output-weights", "gan", "--data-parallel", "--model-parallel", "2"]
    resume = os.path.join(work, "rank0", "A", "gan.train_state")
    out: dict = {}
    cwd = os.getcwd()
    try:
        for label, args in (("A", ["--epochs", "2"]), ("B", ["--epochs", "4", "--resume", resume]),
                            ("C", ["--epochs", "4"])):
            d = os.path.join(work, f"rank{mesh.rank}", "C" if label == "C" else "A")
            os.makedirs(d, exist_ok=True)
            os.chdir(d)
            parsed = build_parser().parse_args([*base, *args])
            M.barrier(mesh)
            torch.cuda.synchronize()
            _kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                cli_train._train(parsed, {}, mesh, mesh.device)
            torch.cuda.synchronize()
            out[label] = {"seconds": time.perf_counter() - t0,
                          "launches": _kernels.launch_counts(), "files": sorted(os.listdir(d))}
        if M.is_main(mesh):
            out["states"] = [torch.load(os.path.join(work, "rank0", x, "gan.train_state",
                                                     "train_state.pt"), weights_only=True)
                             for x in ("A", "C")]
            out["records"] = read_jsonl(os.path.join(work, "rank0", "A", "gan_2.jsonl"))
    finally:
        os.chdir(cwd)
        if env is None:
            os.environ.pop("VISCOIN_SYNTH_N", None)
        else:
            os.environ["VISCOIN_SYNTH_N"] = env
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    return out


def mp_worker_main(out_dir: str) -> int:
    """`torchrun --nproc-per-node N chip_smoke.py --mp-worker DIR`: with N = 2
    one of two ranks of a (1 data, 2 model) mesh on the one card over gloo
    with CUDA tensors; with N = 1 the one-process reference (world size 1,
    no mesh). Each takes the GAN steps' peaks first (mp_gan_peaks), then
    builds the flagship bundle, the frozen original generator
    and LPIPS from the seeds and runs the fp32 step with TF32 off, then at
    PyTorch's TF32 defaults (the peak memory of each step alone), marks
    DIR/<name>.memory and waits for DIR/go (go_mp), then runs the bf16
    steps (VisCoIN's, then the GAN's); the ranks also the fp32 steps with
    the planted faults, the loop and the GAN command.
    Writes rank<r>.pt (one.pt) to DIR."""
    from viscoin_tpu_torch.parallel import mesh as M

    world = int(os.environ["WORLD_SIZE"])
    mesh = M.make_mesh_2d(1, 2, "cuda:0", backend="gloo") if world == 2 else None
    if mesh is None:
        # The reference's VisCoIN steps eager, as the ranks' (a model axis):
        # it shares the card with them and the main process, and a CUDA
        # graph's private pool would hold its activations a second time.
        T.eager_reason = lambda *a, **k: "reference"
    defaults = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    set_tf32(False)
    t0 = time.perf_counter()
    gan = mp_gan_peaks(mesh, defaults)
    models = default_models(N_CLASSES, N_CONCEPTS, RES, CHANNEL_BASE, CHANNEL_MAX, device="cuda",
                            seed=SEED)
    perturb_constants(models, SEED + 10)
    gen, lpips = train_modules()
    inp = dp_viscoin_inputs()
    rec: dict = {"rank": 0 if mesh is None else mesh.rank, "world": world}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec["resident_mib"] = torch.cuda.memory_allocated() / 2**20
    with PathRecorder() as calls32:
        rec["float32"] = mp_step(models, lpips, inp, mesh, "float32")
    rec["peak_tf32_off_mib"] = torch.cuda.max_memory_allocated() / 2**20
    # The same fp32 step at PyTorch's TF32 defaults, as a user trains: cuDNN's
    # workspaces there are a few hundred MiB, so its peak is the activations'.
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = defaults
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mp_step(models, lpips, inp, mesh, "float32")
    rec["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    set_tf32(False)
    name = "one" if mesh is None else f"rank{mesh.rank}"
    Path(work_marker(out_dir, name)).touch()  # the peaks are taken
    # Idle, holding little, until dp starts.
    torch.cuda.empty_cache()
    t_pause = time.perf_counter()
    while not os.path.exists(os.path.join(out_dir, "go")):
        if time.perf_counter() - t_pause > MP_PAUSE_S:
            raise RuntimeError(f"no signal to go on after {MP_PAUSE_S} s")
        time.sleep(0.5)
    rec["paused_s"] = time.perf_counter() - t_pause
    with PathRecorder() as calls16:
        rec["bfloat16"] = mp_step(models, lpips, inp, mesh, "bfloat16")
    rec["calls"] = {"float32": calls32.unique(), "bfloat16": calls16.unique()}
    if mesh is not None:
        rec["fault"] = mp_step(models, lpips, inp, mesh, "float32", fault=True)
        rec["loop"] = mp_loop(models, gen, lpips, mesh, os.path.join(out_dir, "loop"))
    del models, gen, lpips
    torch.cuda.empty_cache()
    g, d = gan_modules()
    with PathRecorder() as gan16:
        gan["bfloat16"] = mp_gan_steps(g, d, mesh, "bfloat16")
    gan["calls"] = {"float32": gan["calls"], "bfloat16": gan16.unique()}
    if mesh is None:  # the floor: one process under cuDNN's default algorithms
        gan["float32_default_algorithms"] = mp_gan_steps(g, d, None, "float32",
                                                         deterministic=False)
    else:
        gan["fault"] = mp_gan_steps(g, d, mesh, "float32", fault=True, steps=MP_GAN_STEPS[:1])
        del g, d
        torch.cuda.empty_cache()
        gan["command"] = mp_gan_command(mesh, os.path.join(out_dir, "gan_command"))
    rec["gan"] = gan
    rec["seconds"] = time.perf_counter() - t0 - rec["paused_s"]
    torch.save(rec, os.path.join(out_dir, f"{name}.pt"))
    M.destroy_mesh(mesh)
    return 0


def start_mp() -> tuple[Groups, str]:
    """The mp phase's processes, started on the card at once: the two ranks
    of the (1, 2) mesh and the one-process reference."""
    work = tempfile.mkdtemp(prefix="viscoin_mp_")
    return Groups({"mesh": (_torchrun(2, ["--mp-worker", work]), work),
                   "one": (_torchrun(1, ["--mp-worker", work]), work)}), work


def work_marker(work: str, name: str) -> str:
    return os.path.join(work, f"{name}.memory")


def go_mp(work: str) -> None:
    """Let the mp processes go on past their pause (dp starts)."""
    Path(work, "go").touch()


def wait_mp_memory(group: Groups, work: str) -> float:
    """Wait until the three mp processes have taken their peaks (their
    markers in ``work``); raises if one of them failed first or after
    MP_MEMORY_WAIT_S. Returns the seconds waited."""
    t0 = time.perf_counter()
    names = ("rank0", "rank1", "one")
    while not all(os.path.exists(work_marker(work, n)) for n in names):
        if any(p.poll() not in (None, 0) for p in group.procs.values()):
            group.collect()  # raises with the failing group's output
        if time.perf_counter() - t0 > MP_MEMORY_WAIT_S:
            raise RuntimeError(f"the mp processes took no peaks in {MP_MEMORY_WAIT_S} s")
        time.sleep(0.5)
    return time.perf_counter() - t0


def _net_dev(got: dict, want: dict,
             nets=("concept_extractor", "explainer", "mapping")) -> dict[str, float]:
    """||got - want|| / ||want|| of each network's gradient (its leaves'
    names start with "<net>.")."""
    out = {}
    for net in nets:
        keys = [k for k in want if k.startswith(net + ".")]
        diff = sum(float((got[k].double() - want[k].double()).square().sum()) for k in keys)
        norm = sum(float(want[k].double().square().sum()) for k in keys)
        out[net] = math.sqrt(diff / norm)
    return out


def phase_mp(group: Groups, work: str, card: str) -> tuple[dict, dict]:
    """Model parallelism (parallel/spatial.py) over a (1 data, 2 model) mesh
    of two processes on the one card over gloo, at flagship width (256²,
    256 concepts, channel_base 16384, batch 8 + 8), against one process at
    the same global batch in a process of its own: in fp32 with TF32 off,
    constant synthesis noise and the explainer's mask given, the step's
    metrics and each network's gradient; the planted fault (every halo
    zeroed) far outside those tolerances; one bf16 step finite and within
    MP_BF16_TOL; each rank's launches those of one process; each rank's
    peak memory over the fp32 step at PyTorch's TF32 defaults at most
    MP_PEAK_RATIO of one process's, and over the TF32-off step reported
    (both with the three processes alone on the card);
    the halo exchanges, gathers, scatters and model-group sums per step;
    4 loop steps of train_viscoin (checkpoints by rank 0) and a resume to 4
    bit-equal; then the GAN trainer over the same mesh (mp_gan_record).
    Returns (the record, the kernel calls of the 2-D steps at their shard
    shapes, the VisCoIN step's and the GAN steps', for phase_kernels)."""
    try:
        wall = max(w for w, _ in group.collect(timeout=MP_PAUSE_S).values())
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        one = torch.load(os.path.join(work, "one.pt"), weights_only=False)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out: dict = {"wall_s": wall}
    f32, ref = ranks[0]["float32"], one["float32"]
    out["metrics"] = {k: abs(v - ref["metrics"][k]) / max(abs(ref["metrics"][k]), 1e-6)
                      for k, v in f32["metrics"].items()}
    out["grads"] = _net_dev(f32["grads"], ref["grads"])
    fault = ranks[0]["fault"]
    out["fault_metrics"] = max(abs(v - ref["metrics"][k]) / max(abs(ref["metrics"][k]), 1e-6)
                               for k, v in fault["metrics"].items())
    out["fault_grads"] = max(_net_dev(fault["grads"], ref["grads"]).values())
    b16, b16_ref = ranks[0]["bfloat16"], one["bfloat16"]
    out["bf16_metrics"] = {k: abs(v - b16_ref["metrics"][k]) / max(abs(b16_ref["metrics"][k]),
                                                                    1e-6)
                           for k, v in b16["metrics"].items()}
    out["peak_mib"] = [r["peak_mib"] for r in ranks]
    out["one_peak_mib"] = one["peak_mib"]
    out["peak_ratio"] = max(out["peak_mib"]) / one["peak_mib"]
    out["peak_tf32_off_mib"] = [r["peak_tf32_off_mib"] for r in ranks]
    out["one_peak_tf32_off_mib"] = one["peak_tf32_off_mib"]
    out["peak_ratio_tf32_off"] = max(out["peak_tf32_off_mib"]) / one["peak_tf32_off_mib"]
    out["resident_mib"] = [r["resident_mib"] for r in ranks] + [one["resident_mib"]]
    out["counts"] = [r["float32"]["counts"] for r in ranks]
    out["counts_bf16"] = [r["bfloat16"]["counts"] for r in ranks]
    out["launches_per_step"] = f32["launches"]
    out["seconds"] = [r["seconds"] for r in ranks] + [one["seconds"]]
    loop = [r["loop"] for r in ranks]
    a, b = loop[0]["A"], loop[0]["B"]
    out["loop"] = {"A_s": a["seconds"], "B_s": b["seconds"], "launches_A": a["launches"],
                   "files": a["files"], "files_rank1": loop[1]["A"]["files"]}
    resume_dev = {k: float((b["params"][k] - v).abs().max()) for k, v in a["params"].items()}
    out["loop"]["resume_max_dev"] = max(resume_dev.values())
    say("mp", "(1 data, 2 model) mesh, two ranks on the one card over gloo with CUDA tensors, "
        f"against one process at the same global batch ({BATCH} + {BATCH}) in a process of "
        f"its own, fp32, TF32 off: metrics " + ", ".join(
            f"{k} {v:.3g}" for k, v in out["metrics"].items()) + "; gradients " + ", ".join(
            f"{k} {v:.3g}" for k, v in out["grads"].items())
        + f" (tolerances {MP_LOSS_TOL:g}, {MP_GRAD_TOL:g}); the planted fault (every halo "
        f"zeroed): metrics off by {out['fault_metrics']:.3g}, gradients by "
        f"{out['fault_grads']:.3g}; bf16 step against one process's bf16 step: worst metric "
        f"{max(out['bf16_metrics'].values()):.3g} (tolerance {MP_BF16_TOL:g}); {card}")
    say("mp", "peak memory over the fp32 step, the three processes alone on the card: at "
        "PyTorch's TF32 defaults ranks " + ", ".join(f"{p:.1f}" for p in out["peak_mib"])
        + f" MiB against one process's {one['peak_mib']:.1f} MiB = {out['peak_ratio']:.3f} "
        f"(at most {MP_PEAK_RATIO:g}); with TF32 off ranks " + ", ".join(
            f"{p:.1f}" for p in out["peak_tf32_off_mib"]) + " MiB against "
        f"{one['peak_tf32_off_mib']:.1f} MiB = {out['peak_ratio_tf32_off']:.3f} (reported, "
        f"not held: {MP_PEAK_RATIO:g} is missed there, cuDNN's workspace for "
        "LPIPS's 128-channel convolutions does not shrink with the rows); "
        f"resident before the step {out['resident_mib'][0]:.0f} / {out['resident_mib'][-1]:.0f} "
        f"MiB; per step and rank (fp32): " + "; ".join(
            f"rank {r}: {c['halo']} halo exchanges {c['halo_bytes'] / 2**20:.1f} MiB, "
            f"{c['gather']} gathers {c['gather_bytes'] / 2**20:.2f} MiB, {c['scatter']} "
            f"scatters, {c['sum']} model-group sums {c['sum_bytes'] / 2**10:.1f} KiB"
            for r, c in enumerate(out["counts"])) + "; launches per step and rank "
        f"{out['launches_per_step']} (one process {ref['launches']}); {card}")
    say("mp", f"train_viscoin over the mesh: run A 4 iterations (eval every 2, checkpoints at 0 "
        f"and 2 by rank 0) {a['seconds']:.1f} s, launches {a['launches']}; run B resumed from "
        f"step 3 to 4 {b['seconds']:.1f} s: parameters after step 4 max |B - A| "
        f"{out['loop']['resume_max_dev']:.3g} (bit-equal); rank 0 wrote {a['files']}, rank 1 "
        f"{loop[1]['A']['files']}; the phase's processes {wall:.1f} s from their start to "
        "their end, their pause until dp included (per process, the pause excluded, "
        + ", ".join(f"{t:.1f}" for t in out["seconds"]) + f" s); {card}")
    for r in ranks:
        assert r["float32"]["launches"] == ref["launches"], (r["rank"], r["float32"]["launches"])
        assert r["bfloat16"]["launches"] == b16_ref["launches"], r["rank"]
        for k, t in r["float32"]["after"].items():
            assert torch.equal(t, f32["after"][k]), ("the ranks' parameters differ", k)
        assert all(math.isfinite(v) for v in r["bfloat16"]["metrics"].values()), r["rank"]
        assert r["float32"]["counts"]["halo"] > 0 and r["float32"]["counts"]["sum"] > 0
    for k, v in out["metrics"].items():
        assert v <= MP_LOSS_TOL, ("metric", k, v)
    for k, v in out["grads"].items():
        assert v <= MP_GRAD_TOL, ("gradient", k, v)
    assert max(out["fault_metrics"], out["fault_grads"]) > 100 * MP_GRAD_TOL, out
    assert max(out["bf16_metrics"].values()) <= MP_BF16_TOL, out["bf16_metrics"]
    assert out["peak_ratio"] <= MP_PEAK_RATIO, out["peak_ratio"]
    assert out["loop"]["resume_max_dev"] == 0.0, sorted(resume_dev.items(),
                                                        key=lambda kv: -kv[1])[:5]
    check_records(a["records"], 2, "mp")
    assert {"viscoin0-2", "viscoin1-2", "train_state"} <= set(a["files"]), a["files"]
    assert loop[1]["A"]["files"] == [], loop[1]["A"]["files"]
    out["gan"] = mp_gan_record([r["gan"] for r in ranks], one["gan"], card)
    calls = {f"the mp step's shard shapes ({d})": ranks[0]["calls"][d]
             for d in ("float32", "bfloat16")}
    calls.update({f"the mp GAN steps' shard shapes ({d})": ranks[0]["gan"]["calls"][d]
                  for d in ("float32", "bfloat16")})
    return out, calls


def _gan_dev(got: dict, want: dict) -> tuple[dict[str, float], dict[str, float]]:
    """Of one GAN step: each metric's deviation (relative, at least 1e-6
    absolute) and each network's gradient's (``_net_dev``, G and D)."""
    return ({k: abs(v - want["metrics"][k]) / max(abs(want["metrics"][k]), 1e-6)
             for k, v in got["metrics"].items()}, _net_dev(got["grads"], want["grads"], "GD"))


def mp_gan_record(ranks: list[dict], one: dict, card: str) -> dict:
    """The GAN part of phase_mp: the (1, 2) mesh's two steps against one
    process's (fp32, TF32 off, cuDNN's deterministic algorithms: metrics
    within MP_GAN_LOSS_TOL, each network's gradient within MP_GAN_GRAD_TOL of
    its norm, reported against MP_GAN_LOSS_TARGET and MP_GAN_GRAD_TARGET
    beside the floor, one process against itself under cuDNN's default
    algorithms; bf16 metrics
    within MP_GAN_BF16_TOL), the planted fault beyond MP_GAN_FAULT_MIN, the
    ranks' metrics and launches those of one process, each rank's peak at
    PyTorch's TF32 defaults at most MP_PEAK_RATIO of one process's (TF32
    off reported), the collectives per step and rank, and the command's
    resume bit-equal with rank 1 writing nothing."""
    out: dict = {"metrics": {}, "grads": {}, "bf16_metrics": {}, "counts": {}, "launches": {},
                 "floor": {}}
    for label, _ in MP_GAN_STEPS:
        out["metrics"][label], out["grads"][label] = _gan_dev(ranks[0]["float32"][label],
                                                              one["float32"][label])
        out["floor"][label] = _gan_dev(one["float32_default_algorithms"][label],
                                       one["float32"][label])[1]
        b16, ref16 = ranks[0]["bfloat16"][label]["metrics"], one["bfloat16"][label]["metrics"]
        out["bf16_metrics"][label] = max(abs(v - ref16[k]) / max(abs(ref16[k]), 1e-6)
                                         for k, v in b16.items())
        out["counts"][label] = [r["float32"][label]["counts"] for r in ranks]
        out["launches"][label] = ranks[0]["float32"][label]["launches"]
        for r in ranks:
            for dt in ("float32", "bfloat16"):
                assert r[dt][label]["metrics"] == ranks[0][dt][label]["metrics"], (dt, label)
                assert r[dt][label]["launches"] == one[dt][label]["launches"], (dt, label)
    fault = ranks[0]["fault"]["r1+ppl"]["metrics"]
    ref = one["float32"]["r1+ppl"]["metrics"]
    out["fault_metrics"] = max(abs(v - ref[k]) / max(abs(ref[k]), 1e-6) for k, v in fault.items())
    out["peak_mib"] = [r["peak_mib"] for r in ranks]
    out["one_peak_mib"] = one["peak_mib"]
    out["peak_ratio"] = max(out["peak_mib"]) / one["peak_mib"]
    out["peak_tf32_off_mib"] = [r["peak_tf32_off_mib"] for r in ranks]
    out["one_peak_tf32_off_mib"] = one["peak_tf32_off_mib"]
    out["peak_ratio_tf32_off"] = max(out["peak_tf32_off_mib"]) / one["peak_tf32_off_mib"]
    out["resident_mib"] = [r["resident_mib"] for r in ranks] + [one["resident_mib"]]
    out["phase_peaks_mib"] = [r["phase_peaks_mib"] for r in ranks] + [one["phase_peaks_mib"]]
    cmd = [r["command"] for r in ranks]
    dev = tree_deviation(*cmd[0]["states"])
    out["command"] = {k: {"seconds": cmd[0][k]["seconds"], "launches": cmd[0][k]["launches"],
                          "files": cmd[0][k]["files"], "files_rank1": cmd[1][k]["files"]}
                      for k in ("A", "B", "C")}
    out["command"]["resume_max_dev"] = max(dev.values())
    out["command"]["state_tensors"] = len(dev)
    worst = {label: max(v.values()) for label, v in out["metrics"].items()}
    met = {"metrics": max(worst.values()) <= MP_GAN_LOSS_TARGET,
           "gradients": max(v for g in out["grads"].values() for v in g.values())
           <= MP_GAN_GRAD_TARGET}
    say("mp", f"GAN trainer over the (1 data, 2 model) mesh at the JAX command's width ({RES}², "
        f"z = w = 512, 2 mapping layers, batch {GAN_BATCH}, mbstd 4, ADA at p = {GAN_ADA_P}), "
        "random synthesis noise, each step from a fresh state with G held still, against one "
        "process, fp32, TF32 off, cuDNN's deterministic algorithms: "
        + "; ".join(f"{label} step: worst metric {worst[label]:.3g}, gradients G "
                    f"{out['grads'][label]['G']:.3g}, D {out['grads'][label]['D']:.3g} "
                    f"(one process against itself under cuDNN's default algorithms: G "
                    f"{out['floor'][label]['G']:.3g}, D {out['floor'][label]['D']:.3g})"
                    for label, _ in MP_GAN_STEPS)
        + f" (tolerances {MP_GAN_LOSS_TOL:g}, {MP_GAN_GRAD_TOL:g}; targets "
        f"{MP_GAN_LOSS_TARGET:g} {'met' if met['metrics'] else 'missed'}, "
        f"{MP_GAN_GRAD_TARGET:g} {'met' if met['gradients'] else 'missed'}); the planted fault "
        "(the path-length gradient left un-reduced over the model group): metrics off by "
        f"{out['fault_metrics']:.3g} (at least {MP_GAN_FAULT_MIN:g}); bf16 against one "
        "process's bf16: " + ", ".join(f"{label} {v:.3g}" for label, v in
                                       out["bf16_metrics"].items())
        + f" (tolerance {MP_GAN_BF16_TOL:g}); {card}")
    say("mp", "GAN peak memory over the R1 + path-length step, the three processes alone on the "
        "card: at PyTorch's TF32 defaults ranks " + ", ".join(
            f"{p:.1f}" for p in out["peak_mib"]) + f" MiB against one process's "
        f"{one['peak_mib']:.1f} MiB = {out['peak_ratio']:.3f} (at most {MP_PEAK_RATIO:g}); with "
        "TF32 off (both steps) ranks " + ", ".join(f"{p:.1f}" for p in out["peak_tf32_off_mib"])
        + f" MiB against {one['peak_tf32_off_mib']:.1f} MiB = "
        f"{out['peak_ratio_tf32_off']:.3f} (reported); the peak by phase at the TF32 defaults "
        "(G's gradient, the path length's, D's with R1) " + "; ".join(
            f"{who} " + " / ".join(f"{p:.0f}" for p in ps) + " MiB"
            for who, ps in zip(("rank 0", "rank 1", "one process"), out["phase_peaks_mib"]))
        + "; G and D resident "
        f"{out['resident_mib'][0]:.0f} / {out['resident_mib'][-1]:.0f} MiB; per step and rank "
        "(fp32): " + "; ".join(
            f"{label} rank {r}: {c['halo']} halo exchanges {c['halo_bytes'] / 2**20:.1f} MiB, "
            f"{c['gather']} gathers {c['gather_bytes'] / 2**20:.2f} MiB, {c['scatter']} "
            f"scatters, {c['sum']} model-group sums {c['sum_bytes'] / 2**10:.1f} KiB"
            for label, cs in out["counts"].items() for r, c in enumerate(cs))
        + "; launches per step and rank (those of one process) " + "; ".join(
            f"{label} {v}" for label, v in out["launches"].items()) + f"; {card}")
    c = out["command"]
    say("mp", f"train gan --data-parallel --model-parallel 2 ({MP_GAN_N} synthetic {RES}² images, "
        f"batch {GAN_BATCH}, bf16, the command's `_train` on the mesh, cuDNN deterministic): run "
        f"A 2 iterations {c['A']['seconds']:.1f} s, run B resumed from A to 4 "
        f"{c['B']['seconds']:.1f} s, run C unbroken to 4 {c['C']['seconds']:.1f} s; B against C: "
        f"{c['state_tensors']} tensors of the training state, max |B - C| "
        f"{c['resume_max_dev']:.3g} (bit-equal); rank 0 wrote {c['B']['files']} (A and B) and "
        f"{c['C']['files']} (C), rank 1 {c['B']['files_rank1']} and {c['C']['files_rank1']}; "
        f"launches A {c['A']['launches']}; {card}")
    for label, v in out["metrics"].items():
        assert max(v.values()) <= MP_GAN_LOSS_TOL, ("GAN metric", label, v)
    for label, v in out["grads"].items():
        assert max(v.values()) <= MP_GAN_GRAD_TOL, ("GAN gradient", label, v)
    assert out["fault_metrics"] > MP_GAN_FAULT_MIN, out["fault_metrics"]
    assert max(out["bf16_metrics"].values()) <= MP_GAN_BF16_TOL, out["bf16_metrics"]
    assert out["peak_ratio"] <= MP_PEAK_RATIO, out["peak_ratio"]
    for label, cs in out["counts"].items():
        assert all(x["halo"] > 0 and x["gather"] > 0 and x["sum"] > 0 for x in cs), (label, cs)
    assert c["resume_max_dev"] == 0.0, sorted(dev.items(), key=lambda kv: -kv[1])[:5]
    assert all(c[k]["files_rank1"] == [] for k in ("A", "B", "C")), c
    assert {"gan", "gan.train_state", "gan_2.jsonl", "gan_4.jsonl"} <= set(c["B"]["files"]), c
    assert {"gan", "gan.train_state", "gan_4.jsonl"} <= set(c["C"]["files"]), c
    recs = cmd[0]["records"]
    assert [r["iteration"] for r in recs] == [0, 1], recs
    assert recs[0]["r1"] > 0 and recs[0]["pl_lengths"] > 0, recs[0]
    assert all(math.isfinite(v) for r in recs for v in r.values()), recs
    return out


# ---------------------------------- timings --------------------------------- #


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
        # where there is one, reads the second order's dy_add (fp32) where
        # given. Per element: the bias add, gain and act' products, with a
        # clamp the recomputed output and its factor, the db sum, the dy_add.
        has_bias, need_db = extra[0] is not None, extra[0] is not None and extra[2]
        has_add = bool(extra[3])
        nbytes = 3 * n_in * esize + (shape[1] * esize if has_bias else 0) \
            + (shape[1] * 4 if need_db else 0) + (shape[1] * 4 if has_add else 0)
        flops = n_in * (2 + has_bias + (3 if kw["clamp"] is not None else 0) + need_db
                        + has_add)
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


# The profiler's kernels of each wrapper, by a substring of their names:
# "bias_act_grad" holds both kernels of its entry call, bias_act_grad_kernel
# and, where the call sums db, bias_act_grad_db_kernel (device_kernels).
KERNEL_SYMBOLS = {"bias_act": "bias_act_kernel", "bias_act_grad": "bias_act_grad",
                  "upfirdn2d": "upfirdn2d_tiled"}
TOP_SHAPES = {"upfirdn2d": 4, "bias_act": 3, "bias_act_grad": 3}  # per-shape rows in full


def device_kernels(call: tuple) -> int:
    """Kernels one recorded entry call launches on the device: two for a
    bias_act_grad call that sums db (a bias, need_db), one otherwise."""
    return 2 if call[0] == "bias_act_grad" and call[3][0] is not None and call[3][2] else 1


def kernels_want(calls: dict[tuple, int]) -> dict[str, int]:
    """Device kernels of each wrapper over recorded calls (call -> times
    made): what a profiler session of that work must record."""
    return {name: sum(m * device_kernels(c) for c, m in calls.items() if c[0] == name)
            for name in KERNELS}


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
    all ``launches`` device kernels of each call (at least one per call when
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


# The timings phase's depth: CUDA events over TIMING_ITERS launches (after 3
# warm-up calls) for each kernel, plain version and yardstick, and for the
# profiler's per-shape device time; the profiler's sum over a whole path from
# PATH_ITERS runs of it (a GAN cycle or the projection is thousands of
# launches per run); HOST_CALLS calls for a wrapper's host cost. A call that
# an earlier path made keeps its times (_TIMED).
TIMING_ITERS, PATH_ITERS, HOST_CALLS = 10, 2, 300
_TIMED: dict[tuple, tuple] = {}


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
        if call not in _TIMED:  # a call of an earlier path is not timed again
            lib = run_library(call, x, arg, kw)
            _TIMED[call] = (cuda_ms(lambda: run_kernel(call, x, arg, kw), iters=TIMING_ITERS),
                            cuda_ms(lambda: run_plain(call, x, arg, kw), iters=TIMING_ITERS),
                            cuda_ms(lib, iters=TIMING_ITERS) if lib is not None else None)
        t_k, t_p, t_l = _TIMED[call]
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
        rows.append(dict(op=call[0], shape=list(call[1]), args=dict(call[4]), extra=call[3],
                         dtype=str(call[2]).removeprefix("torch."), calls=mult,
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
            r["device_ms"] = device_ms(lambda: run_kernel(call, x, arg, kw), KERNEL_SYMBOLS[name],
                                       iters=TIMING_ITERS, launches=device_kernels(call))
            lib = run_library(call, x, arg, kw)
            r["library_device_ms"] = (device_ms(lib, None, iters=TIMING_ITERS)
                                      if lib is not None else None)
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
    def run_all(mine):
        for c, m in mine:
            for _ in range(m):
                run_kernel(c, *inputs[c])  # each output freed at once

    for name in names:
        mine = [(c, m) for c, m in calls.items() if c[0] == name]
        sums[name]["device_ms"] = device_ms(lambda: run_all(mine), KERNEL_SYMBOLS[name],
                                            iters=PATH_ITERS,
                                            launches=kernels_want(dict(mine))[name])
    say("timings", f"{label}, summed over the path's calls: " + "; ".join(
        f"{n}: kernel {s['ms']:.4f} ms by events, {fmt_ms(s['device_ms'])} device "
        f"(profiler), plain {s['plain_ms']:.4f} ms, bound {s['bound_ms']:.4f} ms, "
        f"library {format(s['library_ms'], '.4f') if s['lib_all'] else 'none'}"
        for n, s in sums.items()) + f"; {card}")
    # The wrappers' host cost at their smallest path shape: the direct launch
    # (what eager calls take) and the registered operator (a loaded artifact's).
    host = {}
    for name in names:
        call = min((c for c in calls if c[0] == name), key=lambda c: math.prod(c[1]))
        x, arg, kw = inputs[call]
        host[name] = dict(shape=list(call[1]),
                          us=host_us(lambda: run_kernel(call, x, arg, kw), HOST_CALLS),
                          op_us=host_us(lambda: run_op(call, x, arg, kw), HOST_CALLS))
        say("timings", f"{label} {name} wrapper at {call[1]}: {host[name]['us']:.2f} us of "
            f"host time per call direct, {host[name]['op_us']:.2f} us through "
            f"torch.ops.viscoin.{name} ({HOST_CALLS} calls, one synchronise); {card}")
    inputs.clear()
    return sums, rows, host


def kernel_entry(name: str, s: dict, launches: int, over: str) -> dict:
    return {"name": name, "route": "cuda", **KERNELS[name], "op": f"viscoin::{name}",
            "launches": launches,
            "max_abs_err": None, "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"],
            "bound_by": "bytes" if s["bytes_ms"] >= s["ops_ms"] else "operations",
            "library_ms": s["library_ms"] if s["lib_all"] else None, "ms_over": over}


def phase_timings(models, path_calls: dict[str, dict[tuple, int]], loop_calls: dict,
                  train_calls: dict[str, dict[tuple, int]], eval_calls: dict[str, dict],
                  gan_cycle_calls: dict, fid_calls: dict, tool_calls: dict[str, dict],
                  device: dict) -> dict:
    """The loop's run A (``loop_calls``: every call it made, as often as it
    made it), which the kernels line carries: its launches and its times
    describe the same work; beside it the GAN's 16-step fp32 cycle
    (``gan_cycle_calls``, likewise), one FID estimate, the projection's
    timed steps and one PPL batch (``tool_calls``); then, for the per-shape rows, serving
    per reconstruct device batch, training per train step, and the loop's
    new shapes per probe chunk and per amplify call (fp32)."""
    tf32_defaults(device)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    card = device["nvidia_smi"]
    over = (f"the loop's run A: 8 fp32 train steps (a warm-up pass, then 8 replays of the "
            f"step's CUDA graph), 4 sampler calls, {2 * EVAL_BATCHES} eval "
            f"batches of {BATCH}, 1 probe chunk of {TE.PROBE_BATCH}; every kernel call as often "
            "as the run made it")
    sums, rows, host = time_path("float32 loop run A (summed)", loop_calls, gen, card)
    detail = {"loop_run_a": {"rows": rows, "sums": sums, "host": host}}
    kernels = {name: kernel_entry(name, sums[name],
                                  sum(m for c, m in loop_calls.items() if c[0] == name), over)
               for name in KERNELS}
    none = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, lib_all=False, bytes_ms=0.0,
                ops_ms=0.0)
    paths = (
        ("gan_cycle", "float32 GAN 16-step cycle (summed)", gan_cycle_calls,
         f"the GAN's 16-step fp32 cycle at batch {GAN_BATCH} (1 R1 + path-length step, 3 "
         "path-length steps, 12 plain): every kernel call as often as it made it"),
        ("fid_sampling", "float32 FID sampling (summed)", fid_calls,
         f"one in-loop FID estimate of `train gan --fid-every`: {FID_SAMPLES} fakes, "
         f"{-(-FID_SAMPLES // FID_BATCH)} EMA-generator batches of {FID_BATCH} at {RES}² under "
         "no_grad; every kernel call as often as it made it (it makes no bias_act_grad call)"),
        ("projection", "float32 projection (summed)", tool_calls["the projection's timed steps"],
         f"`project`'s {PROJ_STEPS} timed steps at batch 1, {RES}², full width (TF32 at the "
         "defaults), and the w_avg mapping of 2048 z before them: every kernel call as often "
         "as it made it"),
        ("ppl_batch", "float32 PPL batch (summed)", tool_calls["one PPL batch"],
         f"one batch of `fid --metric ppl`: {PPL_BATCH} segments, the mapping of 2 x "
         f"{PPL_BATCH} z and one synthesis of {2 * PPL_BATCH} images at {RES}², no_grad, TF32 "
         "off (no bias_act_grad call)"),
        ("amplify_pca", "float32 amplify-pca --pca 2 (summed)",
         tool_calls["amplify-pca --pca 2"],
         f"`amplify-pca --pca 2 --image 0`'s computation at {RES}², full width: the W+ pass "
         f"over {ANALYSIS_N} train and {ANALYSIS_N} test images (the adapted mapping at N = "
         "32, 4 batches) and one gen_from_w call of 5 images per component, no_grad, TF32 "
         "off; every kernel call as often as it made it (no bias_act_grad call)"),
        ("amplify", "float32 amplify --concept-top-k 4 (summed)",
         tool_calls["amplify --concept-top-k 4"],
         f"`amplify --concept-top-k 4 --image-indices 0,1` as a command at {RES}², full "
         "width: per image one generator pass of 2M + 1 = 9 images (the adapted mapping and "
         "the synthesis), no_grad, TF32 at the defaults; every kernel call as often as it made "
         "it (no bias_act_grad call)"),
        ("concept2clip_w", "float32 train concept2clip --latent-type gan (summed)",
         tool_calls["train concept2clip --latent-type gan"],
         f"`train concept2clip --latent-type gan`: its W+ pass over {C2C_N} train and {C2C_N} "
         f"test images at {RES}², full width (the adapted mapping at N = 32, "
         f"{2 * C2C_N // 32} batches; CLIP and the adapter launch none), no_grad, TF32 at the "
         "defaults; every kernel call as often as it made it (no bias_act_grad call)"),
    )
    for prefix, label, calls, over in paths:
        sums, rows, host = time_path(label, calls, gen, card)
        detail[prefix] = {"rows": rows, "sums": sums, "host": host}
        for name, entry in kernels.items():
            path = kernel_entry(name, sums.get(name, none),
                                sum(m for c, m in calls.items() if c[0] == name), over)
            entry.update({f"{prefix}_{k}": path[k] for k in ("launches", "ms", "plain_ms",
                                                             "bound_ms", "bound_by",
                                                             "library_ms", "ms_over")})
    for dtype_name, calls in path_calls.items():
        sums, rows, host = time_path(f"{dtype_name} per reconstruct batch of {BATCH}", calls,
                                     gen, card)
        detail[dtype_name] = {"rows": rows, "sums": sums}
        detail[f"host_{dtype_name}"] = host
    for dtype_name, calls in train_calls.items():
        sums, rows, host = time_path(f"{dtype_name} per train step (batch {BATCH})", calls,
                                     gen, card)
        detail[f"train_{dtype_name}"] = {"rows": rows, "sums": sums, "host": host}
    for label, calls in eval_calls.items():
        sums, rows, host = time_path(f"float32 {label}", calls, gen, card)
        detail[label] = {"rows": rows, "sums": sums, "host": host}

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
        per_batch = kernels_want(path_calls[dtype])
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


# ---------------------------------- lanes ---------------------------------- #

# Two groups of phases run in processes of their own beside the main process's
# phases from export to concept2clip: the GAN lane (gan, its kernel and adjoint
# checks, gan-cpu, and beside gan-cpu the cli and gan-cli commands) and the
# pipeline lane (port, fid, classifier, gan-tools, in one directory). Each
# process counts its own launches; its lines are printed when it is joined.
LANE_TIMEOUT_S = 1100


def lane_gan(device: dict) -> dict:
    """Phases 11-14: the GAN step's phases on the card, and beside gan-cpu
    the commands of cli and gan-cli (processes of their own)."""
    card = device["nvidia_smi"]
    out: dict = {}
    g, d = gan_modules()
    tf32_defaults(device)
    out["gan"], gan_calls = phase_gan(g, d, card)
    out["gan_cycle_calls"] = out["gan"].pop("cycle_calls")
    set_tf32(False)
    out["worst_gan"] = phase_kernels(gan_calls, configurations=False)
    out["gan_adjoint"] = phase_adjoint({c: m for label, calls in gan_calls.items()
                                        if "float32" in label for c, m in calls.items()},
                                       "the GAN step's (every cadence type)")
    pool = ThreadPoolExecutor(1)
    try:
        commands = pool.submit(lambda: (phase_cli(card), phase_gan_cli(card)))
        out["gan_cpu"] = phase_gan_cpu(g, d)
        out["cli"], out["gan_cli"] = commands.result()
    finally:
        pool.shutdown(wait=True)
    return out


def lane_pipeline(device: dict) -> dict:
    """Phases 15-18 in one directory, laid out as a user's: weights in and
    out, the FID detector, the classifier stage, the GAN tools."""
    out: dict = {}
    set_tf32(False)
    work = tempfile.mkdtemp(prefix="viscoin_pipeline_")
    try:
        out["port"] = phase_port(work, device["nvidia_smi"])
        torch.cuda.empty_cache()
        out["fid"], out["fid_calls"] = phase_fid(work, device)
        out["classifier"] = phase_classifier(work, device)
        torch.cuda.empty_cache()
        out["gan_tools"], out["tool_calls"] = phase_gan_tools(work, device)
    finally:
        ckpt.wait_for_saves()
        shutil.rmtree(work, ignore_errors=True)
    return out


LANES = {"gan": lane_gan, "pipeline": lane_pipeline}


def lane_main(name: str, work: str) -> int:
    """`python chip_smoke.py --lane NAME DIR`: the lane's phases, the device
    record read from DIR/device.json; the lane's record to DIR/NAME.pt."""
    global _START
    _START = float(os.environ["CHIP_SMOKE_START"])  # the main process's clock
    with open(os.path.join(work, "device.json")) as f:
        device = json.load(f)
    torch.save(LANES[name](device), os.path.join(work, f"{name}.pt"))
    return 0


class Lane:
    """A lane started in a session of its own, its standard output to a
    file; :meth:`result` waits for it, prints its lines and returns its
    record. Killed if the ``with`` block exits first."""

    def __init__(self, name: str, device: dict):
        self.name, self.t0 = name, time.perf_counter()
        self.work = tempfile.mkdtemp(prefix=f"viscoin_lane_{name}_")
        with open(os.path.join(self.work, "device.json"), "w") as f:
            json.dump(device, f)
        self.log = open(os.path.join(self.work, "stdout.log"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--lane", name, self.work],
            env={**os.environ, "CHIP_SMOKE_START": repr(_START)}, stdout=self.log,
            start_new_session=True)
        self.done = None

    def result(self) -> dict:
        if self.done is not None:
            return self.done
        left = max(1.0, LANE_TIMEOUT_S - (time.perf_counter() - self.t0))
        try:
            code = self.proc.wait(timeout=left)
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"the {self.name} lane timed out after {LANE_TIMEOUT_S} s") \
                from None
        finally:
            self.log.seek(0)
            sys.stdout.write(self.log.read())
            sys.stdout.flush()
        if code != 0:
            raise RuntimeError(f"the {self.name} lane exited {code}")
        self.done = torch.load(os.path.join(self.work, f"{self.name}.pt"), weights_only=False)
        return self.done

    def kill(self) -> None:
        import signal

        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait(timeout=60)
        self.log.close()
        shutil.rmtree(self.work, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.kill()


# ----------------------------------- main ----------------------------------- #


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write every number to this JSON file")
    parser.add_argument("--dp-command", metavar="OUT", help=argparse.SUPPRESS)
    parser.add_argument("--dp-worker", metavar="DIR", help=argparse.SUPPRESS)
    parser.add_argument("--mp-worker", metavar="DIR", help=argparse.SUPPRESS)
    parser.add_argument("--lane", nargs=2, metavar=("NAME", "DIR"), help=argparse.SUPPRESS)
    parser.add_argument("command", nargs=argparse.REMAINDER, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    # The dp phase's own processes (under torchrun): see phase_dp.
    if args.dp_command:
        argv = args.command[1:] if args.command[:1] == ["--"] else args.command
        return dp_command_main(args.dp_command, argv)
    if args.dp_worker:
        return dp_worker_main(args.dp_worker)
    if args.mp_worker:
        return mp_worker_main(args.mp_worker)
    if args.lane:
        return lane_main(*args.lane)
    # The driver's time limit ends this process with SIGTERM: leave through
    # the ``with`` blocks, which kill the processes started below.
    import signal

    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
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
    eval_calls = record_eval_calls(models)
    gen, lpips = train_modules()
    runs = {dtype: TrainRun(models, gen, lpips, dtype) for dtype in ("float32", "bfloat16")}
    train_calls = {dtype: run.record() for dtype, run in runs.items()}
    say("kernels", "path shapes: " + ", ".join(
        f"{label} {d}: {len(c)} distinct calls, {sum(c.values())} launches"
        for label, calls in (("per reconstruct batch", path_calls),
                             ("per train step", train_calls)) for d, c in calls.items())
        + "; " + ", ".join(f"{label} float32: {len(c)} distinct calls, {sum(c.values())} "
                           "launches" for label, c in eval_calls.items()))
    worst = phase_kernels({**path_calls, **{f"train_{d}": c for d, c in train_calls.items()},
                           **eval_calls})
    record["adjoint"] = phase_adjoint(train_calls["float32"])
    torch.cuda.empty_cache()
    # The mp phase's processes: their peaks beside this process's next phases
    # (the lanes wait for them), then idle until dp; read after dp.
    mp_group, mp_work = start_mp()
    with mp_group:
        record["slice"] = phase_slice(models)
        record["cpu"] = phase_cpu(models)
        record["server"] = phase_server(models)
        record["train_cpu"] = phase_train_cpu(models, lpips)
        record["mp_memory_wait_s"] = wait_mp_memory(mp_group, mp_work)
        say("mp", "the three mp processes, started after the kernel checks, took their peaks "
            "with no other process on the card; the lanes waited "
            f"{record['mp_memory_wait_s']:.1f} s for them")
        with Lane("pipeline", record["device"]) as pipeline, \
                Lane("gan", record["device"]) as gan_lane:
            say("lanes", "started the pipeline lane (port, fid, classifier, gan-tools) and the "
                "GAN lane (gan, gan-cpu, and beside it cli and gan-cli), each a process of its "
                "own, beside this process's phases from export to dp: walls, medians and "
                "busy shares from here to dp are taken under contention")
            record["export"] = phase_export(models, record["device"])
            tf32_defaults(record["device"])
            record["train"], train_launches = phase_train(runs, models,
                                                          record["device"]["nvidia_smi"],
                                                          train_calls)
            del runs
            torch.cuda.empty_cache()
            tf32_defaults(record["device"])
            record["loop"] = phase_loop(models, gen, lpips, record["train"],
                                        record["device"]["nvidia_smi"])
            torch.cuda.empty_cache()
            assert record["loop"]["launches_per_step"] == train_launches, train_launches
            tmp = tempfile.mkdtemp(prefix="viscoin_analysis_")
            try:
                record["analysis"], analysis_calls = phase_analysis(
                    models, record["device"], record["loop"]["jsonl_a"], tmp)
                torch.cuda.empty_cache()
                record["concept2clip"], c2c_calls = phase_concept2clip(
                    os.path.join(tmp, "viscoin-flagship"), record["device"])
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            torch.cuda.empty_cache()
            lane = gan_lane.result()
            for key in ("gan", "gan_adjoint", "gan_cpu", "cli", "gan_cli"):
                record[key] = lane[key]
            gan_cycle_calls, worst_gan = lane["gan_cycle_calls"], lane["worst_gan"]
            go_mp(mp_work)  # the rest of the mp processes' work beside dp's (a)
            record["dp"] = phase_dp(models, record["device"], beside=mp_group)
            record["mp"], mp_calls = phase_mp(mp_group, mp_work, record["device"]["nvidia_smi"])
            lane = pipeline.result()
            for key in ("port", "fid", "classifier", "gan_tools"):
                record[key] = lane[key]
            fid_calls, tool_calls = lane["fid_calls"], lane["tool_calls"]
    set_tf32(False)
    worst_fid = phase_kernels({"the FID sampling": fid_calls, **tool_calls, **analysis_calls,
                               **c2c_calls}, configurations=False)
    # The mp steps' calls at their shard shapes (halo-extended, cropped): the
    # VisCoIN step's, then the GAN steps' (D's FIRs on rows, second order).
    record["mp"]["max_abs_err"] = worst_mp = phase_kernels(
        {k: v for k, v in mp_calls.items() if "GAN" not in k}, configurations=False)
    record["mp"]["gan"]["max_abs_err"] = worst_mp_gan = phase_kernels(
        {k: v for k, v in mp_calls.items() if "GAN" in k}, configurations=False)
    worst_fid = {k: max(v, worst_mp[k], worst_mp_gan[k]) for k, v in worst_fid.items()}
    loop_calls = record["loop"].pop("calls_a")
    # Run A's calls against the plain versions too (the kernels line's path).
    worst_loop = phase_kernels({"the loop's run A": loop_calls}, configurations=False)
    worst = {k: max(v, worst_loop[k], worst_gan[k], worst_fid[k]) for k, v in worst.items()}
    timings = phase_timings(models, path_calls, loop_calls, train_calls, eval_calls,
                            gan_cycle_calls, fid_calls,
                            {**tool_calls, **analysis_calls, **c2c_calls}, record["device"])
    for name, entry in timings["kernels"].items():
        assert entry["launches"] == record["loop"]["launches"][name], (name, entry)
        assert entry["gan_cycle_launches"] == record["gan"]["float32"]["cycle_launches"][name]
        assert entry["fid_sampling_launches"] == record["fid"]["launches"][name], (name, entry)
        assert entry["projection_launches"] == record["gan_tools"]["project"]["launches"][name]
        assert entry["ppl_batch_launches"] == \
            record["gan_tools"]["ppl"]["launches_per_batch"][name], (name, entry)
        assert entry["amplify_pca_launches"] == \
            record["analysis"]["w_space"]["amplify_pca"]["launches"][name], (name, entry)
        assert entry["amplify_launches"] == \
            record["analysis"]["commands"]["launches"]["amplify"][name], (name, entry)
        assert entry["concept2clip_w_launches"] == \
            record["concept2clip"]["command"]["gan"]["launches"][name], (name, entry)
    record["timings"] = timings
    record["max_abs_err"] = worst
    record["profiler_misses"] = PROFILER_MISSES
    for name, entry in timings["kernels"].items():
        entry["max_abs_err"] = worst[f"{name}/float32"]
        entry["mp_step_launches"] = record["mp"]["launches_per_step"][name]
        entry["mp_gan_step_launches"] = record["mp"]["gan"]["launches"]["r1+ppl"][name]
        entry["mp_gan_plain_step_launches"] = record["mp"]["gan"]["launches"]["plain"][name]
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
