"""Serving traffic of the reconstruct endpoint: an open loop of arrivals at
a fixed rate, one 256² u8 image per request, each through the program's
request handler (``VisCoINServer.handle_reconstruct``: the micro-batcher,
the engine's device batch, the npz response bytes), without the socket
layer.

The arrival gaps are a fixed set (the exponential distribution's quantiles
at the cell's rate) in an order drawn from the seed, so every seed offers
the same number of requests over the same span. A dispatcher thread hands
each request to a client thread when it falls due; a request's latency runs
from the moment it was due to the moment its response bytes are ready.
"""

from __future__ import annotations

import contextlib
import math
import statistics
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from perfbench.harness import core, trace, weights
from perfbench.harness.bundle import viscoin_bundle
from perfbench.reference import viscoin as VC
from perfbench.reference.steps import fold_seed, reconstruct

DATA_TAG = 0x44415441  # "DATA"
ARRIVAL_TAG = 0x41525256  # "ARRV"
SAMPLE_TAG = 0x534D504C  # "SMPL"
NETS = ("classifier", "concept_extractor", "explainer", "gan")
GRACE_S = 60.0  # how long after the window a response may still come


def factories(s: dict) -> dict:
    return {n: f for n, f in VC.factories(s).items() if n in NETS}


def image_pool(ctx, device) -> np.ndarray:
    res = ctx.config["sizes"]["resolution"]
    g = torch.Generator(device=device).manual_seed(fold_seed(ctx.seed, DATA_TAG))
    return torch.randint(0, 256, (ctx.params["pool"], res, res, 3), generator=g, device=device,
                         dtype=torch.uint8).cpu().numpy()


def arrivals(ctx, rate: float, seconds: float) -> tuple[np.ndarray, np.ndarray]:
    """Due times (s from the window's start) and the pool row of each
    request: n = rate * seconds exponential gaps at their quantiles, in
    an order drawn from the seed."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    rng = np.random.default_rng(fold_seed(ctx.seed, ARRIVAL_TAG))
    due = np.cumsum(rng.permutation(gaps))
    due *= seconds / due[-1]
    return due - due[0], rng.integers(0, ctx.params["pool"], n)


def build(ctx, device):
    from viscoin_tpu_torch.serve.engine import InferenceEngine
    from viscoin_tpu_torch.serve.server import VisCoINServer

    s, p = ctx.config["sizes"], ctx.params
    models = viscoin_bundle(s, weights.make_states(factories(s), ctx.seed, device), device)
    engine = InferenceEngine(models, batch_size=p["device_batch"], compute_dtype=p["compute_dtype"],
                             device=device)
    del models
    batch_s: list[float] = []
    inner = engine.reconstruct

    def timed(images_u8):  # one device batch per call: the batcher's max is the engine's batch
        span = (torch.profiler.record_function("bench.engine_batch") if ctx.traced
                else contextlib.nullcontext())
        t = time.perf_counter()
        with span:
            out = inner(images_u8)
        batch_s.append(time.perf_counter() - t)
        return out

    engine.reconstruct = timed
    server = VisCoINServer(engine, max_delay_ms=p["max_delay_ms"])
    return server, engine, batch_s


def window(ctx, server, pool: np.ndarray, rate: float, seconds: float,
           keep: set[int] | None = None):
    """Offer the open loop; returns per-request (due, done or None) seconds,
    the kept responses' bytes by request index, and the dispatcher's
    largest lateness."""
    due, which = arrivals(ctx, rate, seconds)
    n = len(due)
    done = [None] * n
    bodies: dict[int, bytes] = {}
    late = [0.0]
    lock = threading.Lock()

    def client(k: int, t0: float):
        try:
            _, body = server.handle_reconstruct(pool[which[k]][None], {})
            t = time.perf_counter() - t0
            done[k] = t
            if keep is not None and k in keep:
                with lock:
                    bodies[k] = body
        except Exception as e:  # a failed request counts as missing
            print(f"request {k} failed: {e!r}")

    with ThreadPoolExecutor(max_workers=ctx.params["clients"]) as pool_exec:
        t0 = time.perf_counter()
        for k in range(n):
            wait = due[k] - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(wait)
            else:
                late[0] = max(late[0], -wait)
            pool_exec.submit(client, k, t0)
        end = time.perf_counter() - t0
        pool_exec.shutdown(wait=False)
        deadline = time.perf_counter() + GRACE_S
        while any(d is None for d in done) and time.perf_counter() < deadline:
            time.sleep(0.01)
    return due, which, done, bodies, late[0], end


def latencies_ms(due, done) -> list[float]:
    return [math.inf if d is None else (d - t) * 1e3 for t, d in zip(due, done)]


def p95(values: list[float]) -> float:
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def run(ctx) -> None:
    p, device = ctx.params, ctx.device
    server, engine, batch_s = build(ctx, device)
    pool = image_pool(ctx, device)
    for _ in range(p["warm_batches"]):  # the one shape the traffic uses: full device batches
        engine.reconstruct(pool[: p["device_batch"]])
    core.sync(device)
    ctx.setup_done()

    seconds = min(ctx.seconds, trace.TRACED_SECONDS) if ctx.traced else ctx.seconds
    n_req = len(arrivals(ctx, p["rate"], seconds)[0])
    rng = np.random.default_rng(fold_seed(ctx.seed, SAMPLE_TAG))
    keep = set(rng.choice(n_req, size=min(p["check_requests"], n_req), replace=False).tolist())
    batch_s.clear()
    before = server.stats()["reconstruct"]
    core.reset_peak(device)
    with trace.window(ctx.traced) as win:
        due, which, done, bodies, late, end = window(ctx, server, pool, p["rate"], seconds, keep)
    ctx.memory_peak_bytes = core.peak_bytes(device)
    lat = latencies_ms(due, done)
    ctx.attempted, ctx.failed = len(lat), sum(1 for v in lat if math.isinf(v))
    ctx.e2e["serve_p95_ms"] = p95(lat)
    after = server.stats()["reconstruct"]
    batches = after["batches"] - before["batches"]
    ctx.layer.update(
        window_s=end, batch_ms_median=statistics.median(batch_s) * 1e3 if batch_s else None,
        batch_fill_pct=(100.0 * (after["requests"] - before["requests"]) / batches
                        / p["device_batch"] if batches else None))
    ctx.note(f"offered {len(lat)} requests over {end:.3f} s at {p['rate']} /s; dispatcher "
             f"at most {late * 1e3:.3f} ms late; p50 {statistics.median(lat):.3f} ms, "
             f"p95 {ctx.e2e['serve_p95_ms']:.3f} ms, failed {ctx.failed}")
    ctx.trace = win.trace
    server.close()
    del server, engine
    core.free(device)
    judge(ctx, pool, which, bodies, keep, device)


def served(bodies: dict[int, bytes]) -> dict[int, dict]:
    import io

    out = {}
    for k, body in bodies.items():
        with np.load(io.BytesIO(body)) as z:
            out[k] = {n: z[n] for n in z.files}
    return out


def reference_outputs(ctx, device, images_u8: np.ndarray, autocast=None) -> dict[str, np.ndarray]:
    """The reference's logits and reconstructions of ``images_u8`` in blocks
    of the device batch, TF32 off (``autocast``: the control's precision)."""
    s = ctx.config["sizes"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        fac = factories(s)
        st = weights.make_states(factories(ctx.config["sizes"]), ctx.seed, device)
        nets = {n: weights.load(weights.build(fac[n], device), st[n]).eval() for n in NETS}
        del st
        outs = []
        amp = (torch.autocast(device_type=device.type, dtype=autocast) if autocast is not None
               else contextlib.nullcontext())
        for at in range(0, len(images_u8), ctx.params["device_batch"]):
            block = torch.from_numpy(images_u8[at: at + ctx.params["device_batch"]]).to(device)
            with amp:
                o = reconstruct(nets, block)
            outs.append({k: v.float().cpu().numpy() for k, v in o.items()})
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def gaps(recon_u8: np.ndarray, preds: np.ndarray, expl_preds: np.ndarray, ref: dict) -> dict:
    """recon_gap: the largest distance, in u8 levels, of a served pixel from
    the reference's unrounded value; pred_gap: the largest amount by which
    the logit of a served prediction (classifier or explainer) lies below
    the reference's best, over the row's logit spread."""
    recon = float(np.abs(recon_u8.astype(np.float64) - 255.0 * ref["image01"]).max())
    pred = 0.0
    for served_p, logits in ((preds, ref["logits"]), (expl_preds, ref["expl_logits"])):
        rows = np.arange(len(served_p))
        spread = logits.max(axis=1) - logits.min(axis=1)
        g = (logits.max(axis=1) - logits[rows, served_p]) / np.maximum(spread, 1e-30)
        pred = max(pred, float(g.max()))
    return {"recon_gap": recon, "pred_gap": pred}


def judge(ctx, pool, rows_of, bodies, keep, device) -> None:
    limits = ctx.wl["limits"]
    got = served(bodies)
    missing = len(keep) - len(got)
    idx = sorted(got)
    images = pool[rows_of[idx]]
    ref = reference_outputs(ctx, device, images)
    g = gaps(np.stack([got[k]["reconstruction_u8"][0] for k in idx]),
             np.array([got[k]["preds"][0] for k in idx]),
             np.array([got[k]["expl_preds"][0] for k in idx]), ref)
    ctx.check("missing", missing, 0)
    for name, value in g.items():
        ctx.check(name, value, limits[name])


def control(ctx, device) -> dict[str, float]:
    """The reference in bfloat16 against the reference, on the requests a
    run checks."""
    p = ctx.params
    pool = image_pool(ctx, device)
    _, rows_of = arrivals(ctx, p["rate"], ctx.seconds)
    rng = np.random.default_rng(fold_seed(ctx.seed, SAMPLE_TAG))
    idx = sorted(rng.choice(len(rows_of), size=min(p["check_requests"], len(rows_of)),
                            replace=False).tolist())
    images = pool[rows_of[idx]]
    ref = reference_outputs(ctx, device, images)
    low = reference_outputs(ctx, device, images, autocast=torch.bfloat16)
    u8 = np.round(np.clip(low["image01"], 0.0, 1.0) * 255.0).astype(np.uint8)
    return gaps(u8, low["logits"].argmax(1), low["expl_logits"].argmax(1), ref)
