"""Training traffic of StyleGAN2-ADA: the program's alternating G/D step
with its per-step random draws, as its ``train gan`` loop calls them, fed
from a seeded pool of u8 images on the device (no loader), over whole
16-step cycles (one lazy R1 step, four path-length steps).

Set-up builds G and D with seeded weights and a fresh training state (ADA's
p from the cell's value) and runs the first steps through the window's own
calls: the first ``ref_steps`` are compared with the reference, the rest
warm up the shapes of the other step kinds. On several cards each rank
runs its slice of the global batch over NCCL (one process per card).
"""

from __future__ import annotations

import contextlib
import copy
import time

import torch

from perfbench.harness import compare, core, trace, weights
from perfbench.harness.counting import Counted, total
from perfbench.harness.spans import Spans
from perfbench.reference import stylegan as SG
from perfbench.reference.steps import GANHyper, GANReference, draw_gan_step, fold_seed

DATA_TAG = 0x44415441  # "DATA"
LOSSES = ("g_loss", "d_loss", "r1", "pl_lengths")


def factories(s: dict) -> dict:
    res, cb, cm = s["resolution"], s["channel_base"], s["channel_max"]
    return {"G": lambda: SG.Generator(s["z_dim"], s["w_dim"], res, s["mapping_layers"], cb, cm),
            "D": lambda: SG.Discriminator(res, cb, cm, s["mbstd_group"])}


def global_batch(ctx) -> int:
    return ctx.params["batch_per_card"] * ctx.world


def data_pool(ctx, device):
    """The pool of real u8 images (whole, every rank the same)."""
    res = ctx.config["sizes"]["resolution"]
    g = torch.Generator(device=device).manual_seed(fold_seed(ctx.seed, DATA_TAG))
    return torch.randint(0, 256, (ctx.params["pool"], res, res, 3), generator=g, device=device,
                         dtype=torch.uint8)


def rows(ctx, i: int) -> slice:
    """Step i's rows of the pool (the global batch's)."""
    B = global_batch(ctx)
    at = (i * B) % ctx.params["pool"]
    return slice(at, at + B)


def kind(ctx, i: int) -> str:
    s = ctx.config["sizes"]
    r1, pl = i % s["r1_interval"] == 0, i % s["pl_interval"] == 0
    return "r1_pl" if r1 and pl else "r1" if r1 else "pl" if pl else "plain"


def _mesh(ctx):
    """The program's data-parallel mesh over this run's ranks (as torchrun
    would describe it), or None on one card."""
    if ctx.world == 1:
        return None
    import os

    from viscoin_tpu_torch.parallel.mesh import make_mesh

    os.environ.update(RANK=str(ctx.rank), WORLD_SIZE=str(ctx.world), LOCAL_RANK=str(ctx.rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(ctx.layer["port"]))
    return make_mesh(device=ctx.device)


def run(ctx) -> None:
    from viscoin_tpu_torch.models.stylegan import Discriminator, Generator
    from viscoin_tpu_torch.train import gan as T

    p, s, device = ctx.params, ctx.config["sizes"], ctx.device
    mesh = _mesh(ctx)
    B = global_batch(ctx)
    local = slice(None) if mesh is None else mesh.rows(p["batch_per_card"])
    st = weights.make_states(factories(s), ctx.seed, device)
    G = Generator(z_dim=s["z_dim"], w_dim=s["w_dim"], img_resolution=s["resolution"],
                  channel_base=s["channel_base"], channel_max=s["channel_max"],
                  mapping_layers=s["mapping_layers"], device=device)
    D = Discriminator(img_resolution=s["resolution"], channel_base=s["channel_base"],
                      channel_max=s["channel_max"], mbstd_group_size=s["mbstd_group"],
                      device=device)
    weights.load(G, st["G"])
    weights.load(D, st["D"])
    del st
    images = data_pool(ctx, device)
    cfg = T.GANTrainingParams(batch_size=B, compute_dtype=ctx.config["compute_dtype"],
                              augment="ada", augment_p=p["ada_p"], mirror=True)
    state = T.create_gan_train_state(G, D, cfg)
    step_fn = T.make_gan_train_step(G, D, cfg, mesh)
    spans = Spans(ctx.traced)

    def one_step(i: int):
        k = kind(ctx, i)
        with spans("plain_step" if k == "plain" else "reg_step"):
            draws = T.draw_step(cfg, G, ctx.seed, i, device, mesh)
            return step_fn(state, images[rows(ctx, i)][local], draws)[1]

    def leaves(which: str) -> dict[str, torch.Tensor]:
        if which == "grad":
            by_p = {q: o.state[q]["exp_avg"] for o in (state.g_opt, state.d_opt)
                    for q in o.param_groups[0]["params"]
                    if "exp_avg" in o.state.get(q, {})}  # beta1 = 0: the gradient
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
            losses.append({k: float(m[k]) for k in LOSSES})
        if grads is None:
            grads = compare.norms(leaves("grad"))
        if i == p["ref_steps"] - 1:
            now = leaves("param")
            change = compare.norms({n: now[n] - start_params[n] for n in now})
            ada_p = float(state.ada_p)
            del now, start_params
    test = {"losses": losses, "grads": grads, "change": change, "ada_p": ada_p}
    core.sync(device)
    if mesh is not None:
        torch.distributed.barrier()
    spans.seconds.clear()
    ctx.setup_done()

    # The window: whole cycles of r1_interval steps from the first step after set-up.
    seconds = min(ctx.seconds, trace.TRACED_SECONDS) if ctx.traced else ctx.seconds
    cycle = s["r1_interval"]
    first = p["warm_steps"]
    core.reset_peak(device)
    i = first
    with trace.window(ctx.traced) as win:
        t0 = time.perf_counter()
        while True:
            one_step(i)
            i += 1
            if (i - first) % cycle == 0:
                done = time.perf_counter() - t0 >= seconds
                if mesh is not None:  # every rank stops after the same step
                    flag = torch.tensor([float(done)], device=device)
                    torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX)
                    done = bool(flag.item())
                if done:
                    break
        core.sync(device)
        wall = time.perf_counter() - t0
    n_steps = i - first
    ctx.memory_peak_bytes = core.peak_bytes(device)
    ctx.e2e["train_img_s"] = n_steps * B / wall
    ctx.attempted, ctx.failed = n_steps, 0
    mix: dict[str, int] = {}
    for j in range(first, i):
        mix[kind(ctx, j)] = mix.get(kind(ctx, j), 0) + 1
    ctx.layer.update(window_s=wall, steps=n_steps, mix=mix, span_s=dict(spans.seconds))
    ctx.trace = win.trace
    del state, step_fn, G, D, images
    if mesh is not None:
        from viscoin_tpu_torch.parallel.mesh import destroy_mesh

        torch.distributed.barrier()
        destroy_mesh(mesh)
    core.free(device)

    # The reference follows the first steps on the whole global batch, on
    # rank 0's card (every rank's readings are its own of the same update).
    if ctx.rank == 0:
        ref = reference_readings(ctx, device, count=ctx.traced)
        judge(ctx, test, ref)


def reference_readings(ctx, device, autocast=None, count: bool = False) -> dict:
    """The reference's losses of the first ``ref_steps`` steps, its first
    gradients and its change after them, and ADA's p then, from the same
    seed; ``autocast`` a lower precision to compute in (the control); with
    ``count``, the FLOPs and the kernels' bytes of each phase."""
    p, s = ctx.params, ctx.config["sizes"]
    B = global_batch(ctx)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        fac = factories(s)
        st = weights.make_states(factories(s), ctx.seed, device)
        G = weights.load(weights.build(fac["G"], device), st["G"])
        D = weights.load(weights.build(fac["D"], device), st["D"])
        del st
        h = GANHyper(r1_interval=s["r1_interval"], pl_interval=s["pl_interval"],
                     mixing=s["style_mixing_prob"], ada_target=s["ada_target"],
                     ada_interval=s["ada_interval"], ada_kimg=s["ada_kimg"])
        ref = GANReference(G, D, copy.deepcopy(G), h, p["ada_p"], ranks=ctx.world)
        images = data_pool(ctx, device)
        start_params = {n: t.detach().clone() for n, t in {**ref.named_params(),
                                                          **ref.ema_params()}.items()}
        losses, grads, counted = [], None, {}
        amp = (torch.autocast(device_type=device.type, dtype=autocast) if autocast is not None
               else contextlib.nullcontext())

        def counter(i):
            def run_phase(name, fn):
                with Counted(count and name not in counted and i < 2, counted, name):
                    return fn()
            return run_phase

        for i in range(p["ref_steps"]):
            draws = draw_gan_step(h, B, s["z_dim"], s["resolution"], ctx.seed, i, device)
            with amp:
                m = ref.step(images[rows(ctx, i)], draws, counter(i))
            losses.append({k: m[k] for k in LOSSES})
            if grads is None:
                grads = compare.norms(ref.first_grads())
        now = {**ref.named_params(), **ref.ema_params()}
        change = compare.norms({n: now[n].detach() - start_params[n] for n in now})
        return {"losses": losses, "grads": grads, "change": change, "ada_p": ref.ada_p,
                "counted": counted}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


# Phases of each step kind (the reference counts FLOPs and bytes by phase).
PHASES = {"r1_pl": ("g_main", "g_pl", "d_r1"), "r1": ("g_main", "d_r1"),
          "pl": ("g_main", "g_pl", "d_main"), "plain": ("g_main", "d_main")}


def _kept(ref: dict) -> tuple[set[str], set[str]]:
    """The leaves whose change is compared: G's and D's that the reference's
    gradient moves beyond rounding, and the EMA leaves of those of G."""
    keep = compare.moving_leaves(ref["grads"])
    return keep, {n for n in ref["change"] if n.startswith("G_ema.") and "G." + n[6:] in keep}


def _first_step_gap(test: dict, ref: dict, keys) -> float:
    t, r = test["losses"][0], ref["losses"][0]
    return max(abs(t[k] - r[k]) / max(abs(r[k]), 1e-30) for k in keys)


def gaps(test: dict, ref: dict) -> dict[str, float]:
    """The first step's losses (G's and D's), each relative: the later steps
    swing by orders of magnitude on rounding alone (PERF.md); the first
    update's gradient and the change after the compared steps by the worst
    leaf; the EMA's change after them by the worst of its own leaves (each
    moves about (1 - beta) as far as its G leaf, far under the median of
    every leaf's change); ADA's p exactly. (R1's and the path length's
    first values are recorded by :func:`detail`, not compared: neither the
    control nor a fault separates them from sound runs, PERF.md.)"""
    keep, ema = _kept(ref)
    return {"loss_gap": _first_step_gap(test, ref, ("g_loss", "d_loss")),
            "grad_gap": compare.leaf_gap(test["grads"], ref["grads"])[0],
            "change_gap": compare.leaf_gap(test["change"], ref["change"], keep | ema)[0],
            "ema_gap": compare.leaf_gap(test["change"], ref["change"], ema)[0],
            "ada_p_gap": abs(test["ada_p"] - ref["ada_p"])}


def detail(test: dict, ref: dict) -> dict:
    keep, ema = _kept(ref)
    return {"reg_gap": _first_step_gap(test, ref, ("r1", "pl_lengths")),
            "losses": [[t[k] - r[k] for k in LOSSES]
                       for t, r in zip(test["losses"], ref["losses"])],
            "ref_losses": ref["losses"], "ada_p": [test["ada_p"], ref["ada_p"]],
            "grad_leaf": compare.leaf_gap(test["grads"], ref["grads"])[1],
            "change_leaf": compare.leaf_gap(test["change"], ref["change"], keep | ema)[1],
            "ema_leaf": compare.leaf_gap(test["change"], ref["change"], ema)[1]}


def control(ctx, device) -> dict[str, float]:
    ref = reference_readings(ctx, device)
    low = reference_readings(ctx, device, autocast=torch.bfloat16)
    ctx.note(f"control detail {detail(low, ref)}")
    return gaps(low, ref)


def judge(ctx, test: dict, ref: dict) -> None:
    limits = ctx.wl["limits"]
    ctx.note(f"detail {detail(test, ref)}")
    for name, value in gaps(test, ref).items():
        ctx.check(name, value, limits[name])
    c = ref["counted"]
    if c:
        phases: dict[str, int] = {}
        for k, n in ctx.layer["mix"].items():
            for ph in PHASES[k]:
                phases[ph] = phases.get(ph, 0) + n
        ctx.layer["flops"], ctx.layer["bytes"] = total(c, phases)
