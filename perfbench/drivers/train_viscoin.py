"""Training traffic of VisCoIN: the program's training step with its
synthetic batches presampled K steps at a time, as its training loop calls
them, fed from a seeded pool of u8 images and labels on the device (no
loader).

Set-up builds the bundle, the frozen original generator and LPIPS with
seeded weights, starts the state past the ``cd_fid_iteration`` gate and
runs the cell's first steps through the same calls the window makes; those
steps are the ones compared with the reference. The window then runs whole
K-step groups until ``--seconds`` have passed.
"""

from __future__ import annotations

import contextlib
import time

import torch

from perfbench.harness import compare, core, trace, weights
from perfbench.harness.bundle import viscoin_bundle
from perfbench.harness.counting import Counted, total
from perfbench.harness.spans import Spans
from perfbench.reference import viscoin as VC
from perfbench.reference.steps import VisCoINHyper, VisCoINReference, fold_seed

DATA_TAG = 0x44415441  # "DATA"
NETS = ("classifier", "concept_extractor", "explainer", "gan", "generator", "lpips")


def data_pool(ctx, device):
    s, p = ctx.config["sizes"], ctx.params
    g = torch.Generator(device=device).manual_seed(fold_seed(ctx.seed, DATA_TAG))
    res = s["resolution"]
    images = torch.randint(0, 256, (p["pool"], res, res, 3), generator=g, device=device,
                           dtype=torch.uint8)
    labels = torch.randint(0, s["n_classes"], (p["pool"],), generator=g, device=device)
    return images, labels


def rows(ctx, i: int) -> slice:
    B, pool = ctx.params["batch"], ctx.params["pool"]
    at = ((i - ctx.params["start_step"]) * B) % pool
    return slice(at, at + B)


def build_program(ctx, st: dict, device):
    from viscoin_tpu_torch.models.lpips import LPIPS
    from viscoin_tpu_torch.models.stylegan import Generator

    s = ctx.config["sizes"]
    models = viscoin_bundle(s, st, device)
    generator = Generator(z_dim=s["z_dim"], w_dim=s["w_dim"], img_resolution=s["resolution"],
                          channel_base=s["channel_base"], channel_max=s["channel_max"],
                          mapping_layers=s["mapping_layers"], device=device)
    lpips = LPIPS(device=device)
    weights.load(generator, st["generator"])
    weights.load(lpips, st["lpips"])
    return models, generator, lpips


def run(ctx) -> None:
    from viscoin_tpu_torch.train import viscoin as T

    p, device = ctx.params, ctx.device
    B, K, start, warm = p["batch"], p["k"], p["start_step"], p["warm_steps"]
    st = weights.make_states(VC.factories(ctx.config["sizes"]), ctx.seed, device)
    models, generator, lpips = build_program(ctx, st, device)
    del st
    images, labels = data_pool(ctx, device)
    cfg = T.VisCoINTrainingParams(batch_size=B, compute_dtype=ctx.config["compute_dtype"],
                                  fake_presample_steps=K)
    step_fn = T.make_train_step(models, generator, lpips, cfg, external_fakes=True)
    sample_fakes = T.make_sample_fakes(generator, cfg)
    frozen = T.make_frozen(models, generator, lpips, compute_dtype=cfg.compute_dtype)
    state = T.create_train_state(models, cfg)
    state.step = start
    spans = Spans(ctx.traced)
    group = {"start": -1, "fakes": None}

    def one_step(i: int):
        g = (i // K) * K
        if group["start"] != g:
            with spans("sampler"):
                group["fakes"] = sample_fakes(frozen, T.fake_sample_keys(ctx.seed, g, K))
            group["start"] = g
        r = rows(ctx, i)
        with spans("step"):
            rng = T.step_generator(ctx.seed, i, device)
            return step_fn(state, frozen, images[r], labels[r], rng, group["fakes"][i - g])[1]

    def leaves(kind: str) -> dict[str, torch.Tensor]:
        out = {}
        for gname, grp in state.params.items():
            opt = state.gan_opt if gname == "mapping" else state.opt
            for n, prm in grp.items():
                if kind == "param":
                    out[f"{gname}.{n}"] = prm.detach()
                elif "exp_avg" in opt.state.get(prm, {}):  # none: the update never ran
                    out[f"{gname}.{n}"] = opt.state[prm]["exp_avg"] / (1.0 - 0.9)
        return out

    # Set-up: the first steps, through the window's own calls, read back.
    start_params = {n: t.clone() for n, t in leaves("param").items()}
    losses, grads = [], None
    for i in range(start, start + warm):
        m = one_step(i)
        losses.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = compare.norms(leaves("grad"))
    now = leaves("param")
    change = compare.norms({n: now[n] - start_params[n] for n in now})
    del start_params, now
    test = {"losses": losses, "grads": grads, "change": change}
    core.sync(device)
    spans.seconds.clear()
    ctx.setup_done()

    # The window: whole K-step groups, from a group boundary.
    seconds = min(ctx.seconds, trace.TRACED_SECONDS) if ctx.traced else ctx.seconds
    core.reset_peak(device)
    i = start + warm
    with trace.window(ctx.traced) as win:
        t0 = time.perf_counter()
        while True:
            one_step(i)
            i += 1
            if i % K == 0 and time.perf_counter() - t0 >= seconds:
                break
        core.sync(device)
        wall = time.perf_counter() - t0
    n_steps = i - (start + warm)
    ctx.memory_peak_bytes = core.peak_bytes(device)
    ctx.e2e["train_img_s"] = n_steps * B / wall
    ctx.attempted, ctx.failed = n_steps, 0
    ctx.layer.update(window_s=wall, steps=n_steps, sampler_calls=n_steps // K,
                     span_s=dict(spans.seconds))
    ctx.trace = win.trace
    del state, step_fn, sample_fakes, frozen, models, generator, lpips, group
    core.free(device)

    ref = reference_readings(ctx, device, count=ctx.traced)
    judge(ctx, test, ref)


def reference_readings(ctx, device, autocast=None, count: bool = False) -> dict:
    """The reference's losses of the cell's first steps, its first
    gradients and its change after them, from the same seed; ``autocast``
    a lower precision to compute in (the control); with ``count``, the
    FLOPs and the kernels' bytes of one step and of one presampler call."""
    p = ctx.params
    B, K, start, warm = p["batch"], p["k"], p["start_step"], p["warm_steps"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        fac = VC.factories(ctx.config["sizes"])
        st = weights.make_states(VC.factories(ctx.config["sizes"]), ctx.seed, device)
        nets = {n: weights.load(weights.build(fac[n], device), st[n]) for n in NETS}
        del st
        images, labels = data_pool(ctx, device)
        ref = VisCoINReference(nets, VisCoINHyper(k=K))
        start_params = {n: t.detach().clone() for n, t in ref.named_params().items()}
        losses, grads, counted = [], None, {}
        fakes, g0 = None, -1
        amp = (torch.autocast(device_type=device.type, dtype=autocast) if autocast is not None
               else contextlib.nullcontext())
        for i in range(start, start + warm):
            g = (i // K) * K
            counting = count and i == start + 1
            with amp:
                if g != g0:
                    with Counted(counting, counted, "sampler"):
                        fakes, g0 = ref.sample_fakes(ctx.seed, g, B, device), g
                r = rows(ctx, i)
                with Counted(counting, counted, "step"):
                    losses.append(ref.step(images[r], labels[r], i, ctx.seed, fakes[i - g].float()))
            if grads is None:
                grads = compare.norms(ref.first_grads())
        now = ref.named_params()
        change = compare.norms({n: now[n].detach() - start_params[n] for n in now})
        return {"losses": losses, "grads": grads, "change": change, "counted": counted}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def gaps(test: dict, ref: dict) -> dict[str, float]:
    keep = compare.moving_leaves(ref["grads"])
    return {
        # The first step's losses: the later steps' read rounding amplified by
        # Adam's first updates (lr * g / |g| on near-zero elements) as much
        # at fp32 as in bfloat16 (PERF.md).
        "loss_gap": compare.value_gap(test["losses"][:1], ref["losses"][:1],
                                      VisCoINReference.LOSSES, scale_key="total_loss"),
        "grad_gap": compare.leaf_gap(test["grads"], ref["grads"])[0],
        "change_gap": compare.leaf_gap(test["change"], ref["change"], keep)[0],
    }


def detail(test: dict, ref: dict) -> dict:
    """Each step's loss gap and the worst leaves, for the record."""
    keep = compare.moving_leaves(ref["grads"])
    return {"loss_gap_by_step": [compare.value_gap([t], [r], VisCoINReference.LOSSES, "total_loss")
                                 for t, r in zip(test["losses"], ref["losses"])],
            "grad_leaf": compare.leaf_gap(test["grads"], ref["grads"])[1],
            "change_leaf": compare.leaf_gap(test["change"], ref["change"], keep)[1]}


def control(ctx, device) -> dict[str, float]:
    """The gaps of the reference in bfloat16 from the reference."""
    ref = reference_readings(ctx, device)
    low = reference_readings(ctx, device, autocast=torch.bfloat16)
    ctx.note(f"control detail {detail(low, ref)}")
    return gaps(low, ref)


def judge(ctx, test: dict, ref: dict) -> None:
    limits = ctx.wl["limits"]
    ctx.note(f"detail {detail(test, ref)}")
    for name, value in gaps(test, ref).items():
        ctx.check(name, value, limits[name])
    if ref["counted"]:
        ctx.layer["flops"], ctx.layer["bytes"] = total(
            ref["counted"], {"step": ctx.layer["steps"], "sampler": ctx.layer["sampler_calls"]})
