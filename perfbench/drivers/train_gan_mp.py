"""Training traffic of StyleGAN2-ADA in a published mixed-precision setting
(stylegan2-ada-pytorch's ``num_fp16_res`` and ``conv_clamp``), or at a
global 16-bit ``compute_dtype`` the cell's ``params`` give: the program's
alternating G/D step as its ``train gan`` loop calls it, over whole 16-step
cycles, as ``train_gan`` runs it, from a seeded pool of u8 images on the
card.

G, D and ``GANTrainingParams`` come from the program's preset table
(``train/gan.py::GAN_PRESETS``) for a configuration that names a
``preset``, else from its ``sizes`` and the program's defaults; the plain
reference (``reference/stylegan_mp.py``) from the configuration's ``sizes``
alone, so a preset that departs from the published setting reads as a gap.
The numbers are ``train_gan``'s, each where the cell's ``limits`` name it,
and two more. ``image_gap``: G's image of seeded latents and noise at the
set-up weights, before any step, as the step runs G (its parameters cast to
the cell's ``compute_dtype``), against the float32 reference's (relative
L2): the precision of the forward alone, before Adam's first updates turn a
gradient's rounding into steps of lr on the smallest leaves. ``<dtype>_block_gap`` (limit 0): the G and D
block calls of the window that ran in another dtype than the configuration
states for them (float16 from the ``num_fp16_res`` highest resolutions, or
the global dtype), plus the blocks never seen in their dtype; read from the
program's counter (``utils/tracing.py::precision_counts``), reset after
set-up. A program without that counter or the preset table fails at once.

In a traced run the reference is counted at the precision the
configuration states (``MixedCount``): its 16-bit blocks in float16 give
the bytes the program moves and the FLOPs by precision; the difference
from an all-float32 count is the 16-bit kernel calls' bytes. A global
bfloat16 step moves every byte at 2 B and runs every FLOP in bfloat16.
One card.
"""

from __future__ import annotations

import contextlib
import copy
import time

import torch

from perfbench.harness import compare, core, trace, weights
from perfbench.harness.spans import Spans
from perfbench.reference import stylegan_mp as SM
from perfbench.reference.steps import GANHyper, draw_gan_step, fold_seed

TG = core.driver("train_gan")  # the pool, rows, step kinds, gaps and phases of train_gan
IMAGE_TAG = 0x494D4147  # "IMAG": the seeded latents and noise of image_gap


def image_inputs(ctx, device):
    """image_gap's latents (one batch) and its noise generator, from the seed."""
    z = torch.randn((ctx.params["batch_per_card"], ctx.config["sizes"]["z_dim"]), device=device,
                    generator=torch.Generator(device=device).manual_seed(
                        fold_seed(ctx.seed, IMAGE_TAG)))
    return z, torch.Generator(device=device).manual_seed(fold_seed(ctx.seed, IMAGE_TAG, 1))


def compute_dtype(ctx) -> str:
    return ctx.params.get("compute_dtype", ctx.config["compute_dtype"])


def build(ctx, device):
    """The program's G, D and GANTrainingParams, with seeded weights."""
    from viscoin_tpu_torch.models.stylegan import Discriminator, Generator
    from viscoin_tpu_torch.train import gan as T

    s, p = ctx.config["sizes"], ctx.params
    B = p["batch_per_card"]
    res = s["resolution"]
    name = ctx.config.get("preset")
    if name is not None:
        preset = T.GAN_PRESETS[name]
        m, training = preset["model"], dict(preset["training"])
    else:
        m = dict(z_dim=s["z_dim"], w_dim=s["w_dim"], mapping_layers=s["mapping_layers"],
                 channel_base=s["channel_base"], channel_max=s["channel_max"],
                 mbstd_group_size=s["mbstd_group"], num_fp16_res=0, conv_clamp=None)
        training = {}
    G = Generator(z_dim=m["z_dim"], w_dim=m["w_dim"], img_resolution=res,
                  channel_base=m["channel_base"], channel_max=m["channel_max"],
                  mapping_layers=m["mapping_layers"], conv_clamp=m["conv_clamp"],
                  num_fp16_res=m["num_fp16_res"], device=device)
    D = Discriminator(img_resolution=res, channel_base=m["channel_base"],
                      channel_max=m["channel_max"], mbstd_group_size=min(m["mbstd_group_size"], B),
                      conv_clamp=m["conv_clamp"], num_fp16_res=m["num_fp16_res"], device=device)
    st = weights.make_states(SM.factories(s), ctx.seed, device)
    weights.load(G, st["G"])
    weights.load(D, st["D"])
    training.update(batch_size=B, augment="ada", augment_p=p["ada_p"], mirror=True)
    if "compute_dtype" in p or name is None:
        training["compute_dtype"] = compute_dtype(ctx)
    return G, D, T.GANTrainingParams(**training)


def expected_dtypes(ctx) -> tuple[str, dict[str, str]]:
    """The check's name and each G and D block's dtype as the configuration
    states it ("g<res>", "d<res>" -> "fp16" | "bf16" | "fp32")."""
    s = ctx.config["sizes"]
    res = s["resolution"]
    n16 = s.get("num_fp16_res", 0)
    whole = {"float32": "fp32", "bfloat16": "bf16", "float16": "fp16"}[compute_dtype(ctx)]
    low = SM.low_resolution(res, n16)
    blocks = [f"g{2**i}" for i in range(2, res.bit_length())] + \
        [f"d{2**i}" for i in range(3, res.bit_length())]
    out = {b: ("fp16" if n16 and int(b[1:]) >= low else whole) for b in blocks}
    return ("fp16" if n16 else whole) + "_block_gap", out


def block_gap(counts: dict, expected: dict[str, str]) -> int:
    """Block calls in another dtype than expected, plus blocks never seen in
    theirs."""
    gap = 0
    for block, dt in expected.items():
        mine = {k.split(".")[1]: n for k, n in counts.items()
                if k.startswith("blocks.") and k.count(".") == 2 and k.endswith("." + block)}
        gap += sum(n for d, n in mine.items() if d != dt) + (0 if mine.get(dt) else 1)
    return gap


def setup(ctx, device):
    """The program's G, D, state and step, and its readings of the set-up
    steps (the numbers a run compares, ``image`` before any step); returns
    the readings and the objects the window continues with."""
    from viscoin_tpu_torch.train import gan as T

    p = ctx.params
    G, D, cfg = build(ctx, device)
    with torch.no_grad():  # G as the step runs it: its parameters cast to compute_dtype
        z, noise = image_inputs(ctx, device)
        params = T.make_cast(cfg.compute_dtype)({"G": dict(G.named_parameters())})["G"]
        image = torch.func.functional_call(G, params, (z,), dict(
            noise_mode="random", generator=noise)).float().cpu()
        del params
    images = TG.data_pool(ctx, device)
    state = T.create_gan_train_state(G, D, cfg)
    step_fn = T.make_gan_train_step(G, D, cfg)
    spans = Spans(ctx.traced)

    def one_step(i: int):
        with spans("plain_step" if TG.kind(ctx, i) == "plain" else "reg_step"):
            draws = T.draw_step(cfg, G, ctx.seed, i, device)
            return step_fn(state, images[TG.rows(ctx, i)], draws)[1]

    def leaves(which: str) -> dict[str, torch.Tensor]:
        if which == "grad":
            by_p = {q: o.state[q]["exp_avg"] for o in (state.g_opt, state.d_opt)
                    for q in o.param_groups[0]["params"] if "exp_avg" in o.state.get(q, {})}
            return {**{f"G.{n}": by_p[q] for n, q in G.named_parameters() if q in by_p},
                    **{f"D.{n}": by_p[q] for n, q in D.named_parameters() if q in by_p}}
        return {**{f"G.{n}": q.detach() for n, q in G.named_parameters()},
                **{f"D.{n}": q.detach() for n, q in D.named_parameters()},
                **{f"G_ema.{n}": q.detach() for n, q in state.g_ema.named_parameters()}}

    start_params = {n: t.clone() for n, t in leaves("param").items()}
    losses, grads, change, ada_p = [], None, None, None
    for i in range(p["warm_steps"]):
        m = one_step(i)
        if i < p["ref_steps"]:
            losses.append({k: float(m[k]) for k in TG.LOSSES})
        if grads is None:
            grads = compare.norms(leaves("grad"))
        if i == p["ref_steps"] - 1:
            now = leaves("param")
            change = compare.norms({n: now[n] - start_params[n] for n in now})
            ada_p = float(state.ada_p)
            del now, start_params
    test = {"losses": losses, "grads": grads, "change": change, "ada_p": ada_p, "image": image}
    return test, dict(G=G, D=D, cfg=cfg, images=images, state=state, step_fn=step_fn,
                      spans=spans, one_step=one_step)


def run(ctx) -> None:
    from viscoin_tpu_torch.utils import tracing

    if ctx.world != 1:
        raise ValueError(f"{ctx.cell}: the train_gan_mp driver runs on one card")
    tracing.reset_precision_counts()  # a program without the counter fails here, at once
    p, s, device = ctx.params, ctx.config["sizes"], ctx.device
    test, program = setup(ctx, device)
    one_step, spans, cfg = program["one_step"], program["spans"], program["cfg"]
    core.sync(device)
    spans.seconds.clear()
    tracing.reset_precision_counts()
    ctx.setup_done()

    seconds = min(ctx.seconds, trace.TRACED_SECONDS) if ctx.traced else ctx.seconds
    cycle, first = s["r1_interval"], p["warm_steps"]
    core.reset_peak(device)
    i = first
    with trace.window(ctx.traced) as win:
        t0 = time.perf_counter()
        while True:
            one_step(i)
            i += 1
            if (i - first) % cycle == 0 and time.perf_counter() - t0 >= seconds:
                break
        core.sync(device)
        wall = time.perf_counter() - t0
    n_steps = i - first
    ctx.memory_peak_bytes = core.peak_bytes(device)
    ctx.e2e["train_img_s"] = n_steps * cfg.batch_size / wall
    ctx.attempted, ctx.failed = n_steps, 0
    counts = tracing.precision_counts()
    mix: dict[str, int] = {}
    for j in range(first, i):
        mix[TG.kind(ctx, j)] = mix.get(TG.kind(ctx, j), 0) + 1
    ctx.layer.update(window_s=wall, steps=n_steps, mix=mix, span_s=dict(spans.seconds),
                     precision_counts=dict(counts))
    ctx.trace = win.trace
    ctx.note(f"window precision counts {dict(counts)}")
    del program, one_step
    core.free(device)

    name, expected = expected_dtypes(ctx)
    ctx.check(name, block_gap(counts, expected), ctx.wl["limits"][name])
    judge(ctx, test, reference_readings(ctx, device))


def hyper(s: dict) -> GANHyper:
    """The reference's hyperparameters: the configuration's, the program's
    defaults where it states none (cfg auto)."""
    h = GANHyper(r1_interval=s["r1_interval"], pl_interval=s["pl_interval"],
                 mixing=s["style_mixing_prob"], ada_target=s["ada_target"],
                 ada_interval=s["ada_interval"], ada_kimg=s["ada_kimg"])
    for key in ("lr", "r1_gamma", "ema_kimg"):
        if key in s:
            setattr(h, key, s[key])
    return h


def _reference(ctx, device, low_dtype=torch.float32, round_dtype=None):
    s = ctx.config["sizes"]
    fac = SM.factories(s, low_dtype, round_dtype)
    st = weights.make_states(SM.factories(s), ctx.seed, device)
    G = weights.load(weights.build(fac["G"], device), st["G"])
    D = weights.load(weights.build(fac["D"], device), st["D"])
    return SM.GANReferenceMP(G, D, copy.deepcopy(G), hyper(s), ctx.params["ada_p"],
                             pl_batch_shrink=s.get("pl_batch_shrink", 1))


@contextlib.contextmanager
def _exact():
    """TF32 off for the reference."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def reference_readings(ctx, device, low_dtype=torch.float32, autocast=None,
                       round_dtype=None) -> dict:
    """The reference's losses of the first ``ref_steps`` steps, its first
    gradients, its change after them and ADA's p then; the blocks from the
    configuration's 16-bit resolution up in ``low_dtype``, or everything
    under ``autocast``; each block's activations through ``round_dtype``
    and back at its entry and exit, where given."""
    p, s = ctx.params, ctx.config["sizes"]
    B = p["batch_per_card"]
    with _exact():
        ref = _reference(ctx, device, low_dtype, round_dtype)
        with torch.no_grad(), amp_of(device, autocast):
            z, noise = image_inputs(ctx, device)
            image = ref.G(z, "random", noise).float().cpu()
        images = TG.data_pool(ctx, device)
        start = {n: t.detach().clone() for n, t in {**ref.named_params(),
                                                    **ref.ema_params()}.items()}
        losses, grads = [], None
        amp = amp_of(device, autocast)
        for i in range(p["ref_steps"]):
            draws = draw_gan_step(ref.h, B, s["z_dim"], s["resolution"], ctx.seed, i, device)
            with amp:
                m = ref.step(images[TG.rows(ctx, i)], draws)
            losses.append({k: m[k] for k in TG.LOSSES})
            if grads is None:
                grads = compare.norms(ref.first_grads())
        now = {**ref.named_params(), **ref.ema_params()}
        change = compare.norms({n: now[n].detach() - start[n] for n in now})
        return {"losses": losses, "grads": grads, "change": change, "ada_p": ref.ada_p,
                "image": image}


def amp_of(device, autocast):
    return (torch.autocast(device_type=device.type, dtype=autocast) if autocast is not None
            else contextlib.nullcontext())


def gaps(test: dict, ref: dict) -> dict[str, float]:
    """``train_gan``'s numbers and ``image_gap``."""
    image = ref["image"].double()
    return {**TG.gaps(test, ref), "image_gap": float(
        torch.linalg.vector_norm(test["image"].double() - image) / torch.linalg.vector_norm(image))}


def counted(ctx, device, low_dtype) -> dict:
    """FLOPs by precision and the kernels' bytes of each phase of the first
    two steps (an R1 + path-length step, a plain one), the reference's
    16-bit blocks in ``low_dtype``."""
    p, s = ctx.params, ctx.config["sizes"]
    out: dict[str, dict] = {}

    def counter(name, fn):
        if name in out:
            return fn()
        with SM.MixedCount() as c:
            r = fn()
        out[name] = {"flops": dict(c.flops), "bytes": c.bytes}
        return r

    with _exact():
        ref = _reference(ctx, device, low_dtype)
        images = TG.data_pool(ctx, device)
        for i in range(2):
            draws = draw_gan_step(ref.h, p["batch_per_card"], s["z_dim"], s["resolution"],
                                  ctx.seed, i, device)
            ref.step(images[TG.rows(ctx, i)], draws, counter)
    del ref
    core.free(device)
    return out


def layer_counts(ctx, device) -> None:
    """The window's FLOPs (``flops``, ``flops_by_precision``) and kernel
    bytes (``bytes`` at the program's element sizes, ``bytes_16bit`` of its
    16-bit calls) into ``ctx.layer``."""
    phases: dict[str, int] = {}
    for k, n in ctx.layer["mix"].items():
        for ph in TG.PHASES[k]:
            phases[ph] = phases.get(ph, 0) + n

    def window(c: dict, key: str) -> dict:
        return {op: sum(c[ph][key][op] * n for ph, n in phases.items()) for op in c["g_main"][key]}

    full = counted(ctx, device, torch.float32)
    b32 = window(full, "bytes")
    flops32 = window(full, "flops")
    if ctx.config["sizes"].get("num_fp16_res", 0):
        mixed = counted(ctx, device, torch.float16)
        total = window(mixed, "bytes")
        ctx.layer["flops_by_precision"] = window(mixed, "flops")
        ctx.layer["bytes_16bit"] = {op: b32[op] - total[op] for op in b32}
    elif compute_dtype(ctx) != "float32":
        total = {op: v // 2 for op, v in b32.items()}
        ctx.layer["flops_by_precision"] = {"16bit": sum(flops32.values()), "fp32": 0}
        ctx.layer["bytes_16bit"] = dict(total)
    else:
        total = b32
        ctx.layer["flops_by_precision"] = {"16bit": 0, "fp32": sum(flops32.values())}
        ctx.layer["bytes_16bit"] = {op: 0 for op in b32}
    ctx.layer["bytes"] = total
    ctx.layer["flops"] = sum(ctx.layer["flops_by_precision"].values())


def stated_readings(ctx, device) -> dict:
    """The reference at the precision the cell states: its 16-bit blocks
    in float16, or everything under the cell's global 16-bit autocast."""
    if ctx.config["sizes"].get("num_fp16_res", 0):
        return reference_readings(ctx, device, low_dtype=torch.float16)
    dtype = getattr(torch, compute_dtype(ctx))
    return reference_readings(ctx, device, autocast=None if dtype == torch.float32 else dtype)


def control(ctx, device) -> dict[str, float]:
    """The reference one precision below the cell's against itself in
    float32: its 16-bit blocks in bfloat16 (below the stated float16); for
    a cell whose program runs in bfloat16 throughout, the reference under
    bfloat16 autocast with each block's activations (and, in the backward,
    their gradients) rounded through float8 e5m2 at its entry and exit; for
    a float32 cell, the reference under bfloat16 autocast."""
    ref = reference_readings(ctx, device)
    if ctx.config["sizes"].get("num_fp16_res", 0):
        low = reference_readings(ctx, device, low_dtype=torch.bfloat16)
    elif compute_dtype(ctx) == "bfloat16":
        low = reference_readings(ctx, device, autocast=torch.bfloat16,
                                 round_dtype=torch.float8_e5m2)
    else:
        low = reference_readings(ctx, device, autocast=torch.bfloat16)
    ctx.note(f"control detail {TG.detail(low, ref)}")
    return {k: v for k, v in gaps(low, ref).items() if k in ctx.wl["limits"]}


def judge(ctx, test: dict, ref: dict) -> None:
    """Each number the cell's ``limits`` name against its limit (the others
    are noted)."""
    limits = ctx.wl["limits"]
    values = gaps(test, ref)
    ctx.note(f"detail {TG.detail(test, ref)}; not compared: "
             f"{ {k: v for k, v in values.items() if k not in limits} }")
    for name, value in values.items():
        if name in limits:
            ctx.check(name, value, limits[name])
    if ctx.traced:
        layer_counts(ctx, ctx.device)
