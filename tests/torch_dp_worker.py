"""One rank of the port's data-parallel and model-parallel CPU tests
(tests/test_torch_parallel.py, tests/test_torch_dp_train.py,
tests/test_torch_spatial.py, tests/test_torch_mp_train.py,
tests/test_torch_mp_gan.py, tests/test_torch_mp_cli.py): joins a gloo group of WORLD processes on
127.0.0.1 and runs the named scenarios, each reading its inputs from
``<dir>/<scenario>.in.pt`` (written by the test) and writing what it computed
to ``<dir>/<scenario>.rank<r>.pt``. A scenario whose inputs hold ``mesh2d``
= (data, model) runs on that 2-D mesh (``make_mesh_2d``).

    python tests/torch_dp_worker.py RANK WORLD PORT DIR DEVICE SCENARIO [SCENARIO ...]

DEVICE "cpu" runs on the CPU; a CUDA device ("cuda:0") puts every rank's
inputs on that one card and joins over gloo (NCCL refuses two ranks on one
card). It imports torch and the port only. Each ``run_<scenario>(inputs,
mesh)`` also runs without a mesh, which is how the tests compute the
one-process reference on the global batch.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from viscoin_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_batch,
    all_mean,
    all_reduce_grads,
    all_sum,
    barrier,
    broadcast_tree,
    make_mesh,
    make_mesh_2d,
)

def _rows(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """This rank's rows of a global batch (all of them without a mesh)."""
    return x if mesh is None else x[mesh.rows(mesh.local(x.shape[0]))]


def const_noise(*modules) -> None:
    """Make every synthesis network of ``modules`` run with its constant
    noise buffers, whatever noise mode the caller asks for: one process and
    each rank of several then see the same noise per sample."""
    for module in modules:
        synthesis = module.synthesis
        forward = type(synthesis).forward

        def const(ws, *args, _s=synthesis, _f=forward, **kw):
            kw.pop("generator", None)
            kw["noise_mode"] = "const"
            return _f(_s, ws, *args, **kw)

        synthesis.forward = const


# ------------------------------- collectives --------------------------------- #


def collectives_loss(x: torch.Tensor, a: torch.Tensor, v: torch.Tensor, u: torch.Tensor,
                     mesh: Mesh | None) -> torch.Tensor:
    """A rank's loss through every differentiable collective: a nonlinear
    function of the gathered batch (with a minibatch-stddev-like statistic
    that couples the rows), of the mean over the ranks of the local means,
    and of the local rows alone."""
    xg = all_gather_batch(x, mesh)
    std = torch.sqrt(((xg - xg.mean(0)) ** 2).mean(0) + 1e-8)
    f = (torch.tanh(xg @ a) ** 2).sum() + (std * xg[:, :1]).sum()
    m = all_mean(x.mean(0), mesh)
    return f + (m @ v) ** 2 + (torch.sin(x) * u).sum() + all_sum((x ** 3).sum(), mesh)


def run_collectives(inp: dict, mesh: Mesh | None) -> dict:
    """Values, first and second derivatives of :func:`collectives_loss` on
    this rank's rows; all_reduce_grads, broadcast_tree and a barrier on
    rank-dependent tensors."""
    x = _rows(inp["x"], mesh).clone().requires_grad_(True)
    rank = 0 if mesh is None else mesh.rank
    u = _rows(inp["u"], mesh)
    loss = collectives_loss(x, inp["a"], inp["v"], u, mesh)
    (g,) = torch.autograd.grad(loss, x, create_graph=True)
    (h,) = torch.autograd.grad((g ** 2).sum(), x)
    out = {"loss": loss.detach(), "g": g.detach(), "h": h}
    if mesh is not None:
        grads = [inp["grads"][rank][k] for k in sorted(inp["grads"][rank])]
        out["mean_grads"] = all_reduce_grads(grads, mesh)
        tree = {k: t.clone() for k, t in inp["grads"][rank].items()}
        broadcast_tree(tree, mesh)
        out["broadcast"] = tree
        barrier(mesh)
    return out


def run_mbstd(inp: dict, mesh: Mesh | None) -> dict:
    """The discriminator's minibatch stddev on this rank's rows, and the
    gradient of a loss through it."""
    from viscoin_tpu_torch.models.stylegan import MinibatchStdLayer

    x = _rows(inp["x"], mesh).clone().requires_grad_(True)
    y = MinibatchStdLayer(group_size=4)(x, mesh)
    loss = (y ** 2 * _rows(inp["w"], mesh)).sum()
    (g,) = torch.autograd.grad(loss, x)
    return {"y": y.detach(), "g": g}


def run_batchnorm(inp: dict, mesh: Mesh | None) -> dict:
    """Train-mode ConvBN on this rank's rows: outputs, the input's and the
    parameters' gradients, the running statistics."""
    layer = inp["layer"]
    x = _rows(inp["x"], mesh).clone().requires_grad_(True)
    y = layer(x, train=True, mesh=mesh)
    grads = torch.autograd.grad((y * _rows(inp["w"], mesh)).sum(),
                                [x, layer.conv.weight, layer.bn.weight])
    return {"y": y.detach(), "gx": grads[0], "gw": grads[1], "gscale": grads[2],
            "running": (layer.bn.running_mean.clone(), layer.bn.running_var.clone())}


# ------------------------------ the VisCoIN step ------------------------------ #


def run_viscoin_step(inp: dict, mesh: Mesh | None) -> dict:
    """VisCoIN steps (float inputs, external fakes, the global dropout
    mask's rows of this rank: its real rows, then its synthetic ones), one
    per ``inp["micro"]`` entry (the batch reversed for odd entries), so that
    ``gradient_accumulation`` = 2 takes one update on two micro-steps: the
    last metrics, the updated parameters and the Adams' first moments."""
    from viscoin_tpu_torch.train import viscoin as T

    models, lpips = inp["models"], inp["lpips"]
    cfg = T.VisCoINTrainingParams(**inp["cfg"])
    frozen = T.make_frozen(models, None, lpips, cfg.compute_dtype)
    state = T.create_train_state(models, cfg)
    step = T.make_train_step(models, None, lpips, cfg, preprocess=False, external_fakes=True,
                             mesh=mesh)
    B = inp["real"].shape[0]
    for j in range(inp.get("micro", 1)):
        order = torch.arange(B) if j % 2 == 0 else torch.arange(B - 1, -1, -1)
        mask = inp["mask"][torch.cat([order, B + order])]
        mask = torch.cat([_rows(mask[:B], mesh), _rows(mask[B:], mesh)])
        state, metrics = step(state, frozen, _rows(inp["real"][order], mesh),
                              _rows(inp["labels"][order], mesh),
                              torch.Generator(inp["real"].device).manual_seed(0),
                              _rows(inp["fake"][order], mesh), dropout_mask=mask)
    params = {f"{g}.{n}": p.detach().clone() for g, grp in state.params.items()
              for n, p in grp.items()}
    moments = {}
    for opt in (state.opt, state.gan_opt):
        for g, grp in state.params.items():
            for n, p in grp.items():
                if p in opt.state:
                    moments[f"{g}.{n}"] = opt.state[p]["exp_avg"].clone()
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "params": params,
            "exp_avg": moments}


# ----------------------------- model parallelism ----------------------------- #


def _image_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a global NCHW batch on a 2-D mesh: its data
    shard's samples, its model rank's rows of H."""
    x = _rows(x, mesh)
    axis = mesh.model_axis
    return x[:, :, axis.rows(axis.local(x.shape[2]))]


def run_spatial_ops(inp: dict, mesh) -> dict:
    """``parallel/spatial.py`` on this rank's rows of global tensors (one
    model group of ``model`` ranks): the halo exchange for several halos and
    fills; <y, A x> and <A^T y, x>; the gradient of a cubic loss through the
    exchange and the gradient of its squared norm (second order);
    scatter_rows / gather_rows and their backwards; and each sharded op
    (convs, the max pool, the up-conv, the discriminator's down convs, the
    FIRs) with the gradients of a weighted sum of its output (this rank's
    rows of the weights), the down convs to second order (the collectives
    counted up to here); then the collectives differentiated twice, the
    minibatch stddev, the ADA pipe and the discriminator on rows."""
    from viscoin_tpu_torch.ops import conv2d_resample, upfirdn2d
    from viscoin_tpu_torch.parallel import spatial as S

    sp = S.Spatial(axis=mesh.model_axis, plan=S.shard_plan(16, mesh.model_axis.world))
    rows = sp.rows(inp["x"].shape[2])
    x = inp["x"][:, :, rows]
    out: dict = {"halo": {}, "ops": {}}
    for top, bottom, fill in inp["halos"]:
        out["halo"][(top, bottom, fill)] = S.halo_exchange(x, top, bottom, sp, fill)
    top, bottom = inp["adjoint_halo"]
    y = inp["y"][mesh.rank]
    out["inner"] = (float((y * S.halo_exchange(x, top, bottom, sp)).sum()),
                    float((S._HaloAdjoint.apply(y, top, bottom, sp.axis) * x).sum()))
    xg = x.clone().requires_grad_(True)
    loss = (inp["w"][sp.axis.rank] * S.halo_exchange(xg, top, bottom, sp) ** 3).sum()
    (g,) = torch.autograd.grad(loss, xg, create_graph=True)
    (h,) = torch.autograd.grad((g ** 2 * inp["v"][:, :, rows]).sum(), xg)
    out.update(g=g.detach(), h=h)
    xg = x.clone().requires_grad_(True)
    gathered = S.gather_rows(xg, sp)
    (gg,) = torch.autograd.grad((gathered * inp["u"][mesh.rank]).sum(), xg)
    whole = inp["x"].clone().requires_grad_(True)
    scattered = S.scatter_rows(whole, sp)
    (gs,) = torch.autograd.grad((scattered * inp["v"][:, :, rows]).sum(), whole)
    out.update(gathered=gathered.detach(), gather_grad=gg, scattered=scattered.detach(),
               scatter_grad=gs)
    for name, case in inp["ops"].items():
        xg = x.clone().requires_grad_(True)
        w = case.get("w")
        w = None if w is None else w.clone().requires_grad_(True)
        kind = case["kind"]
        if kind == "conv":
            y = S.conv2d(xg, w, None, case["stride"], case["padding"], sp)
        elif kind == "maxpool":
            y = S.max_pool2d(xg, case["k"], case["stride"], case["padding"], sp)
        elif kind == "upconv":
            y = conv2d_resample(xg, w, f=case["f"], up=2, padding=case["padding"],
                                flip_weight=False, sp=sp)
        elif kind == "downconv":
            y = conv2d_resample(xg, w, f=case["f"], down=2, padding=case["padding"], sp=sp)
        else:
            y = upfirdn2d(xg, case["f"], up=case["up"], down=case["down"],
                          padding=case["fir_padding"], gain=case.get("gain", 1.0), sp=sp)
        weight = case["u"][:, :, sp.rows(case["u"].shape[2])]
        grads = torch.autograd.grad((y * weight).sum(), [t for t in (xg, w) if t is not None])
        out["ops"][name] = {"y": y.detach(), "gx": grads[0],
                            "gw": grads[1] if w is not None else None}
        if kind == "downconv":  # second order: the gradient of <u, y^2>, then of <v, g^2>
            xg, w = x.clone().requires_grad_(True), case["w"].clone().requires_grad_(True)
            y = conv2d_resample(xg, w, f=case["f"], down=2, padding=case["padding"], sp=sp)
            (g,) = torch.autograd.grad((y ** 2 * weight).sum(), xg, create_graph=True)
            out["ops"][name]["second"] = torch.autograd.grad(
                (g ** 2 * inp["v"][:, :, rows]).sum(), [xg, w])
    out["counts"] = S.counts()
    out.update(double=_double_backward(x, inp, sp), mbstd=_mbstd_rows(inp, mesh, sp),
               ada=_ada_rows(inp, sp), disc=_disc_rows(inp, mesh, sp))
    return out


def _double_backward(x: torch.Tensor, inp: dict, sp) -> dict:
    """A rank's loss through gather_rows, scatter_rows and model_sum, whole on
    every rank: L = sum over (B, C) of (sum over (H, W) of x^3 u)^2, as
    model_sum(sum of this rank's rows of scatter(gather(x)^2 u) * x)^2; its
    gradient, and the gradient of <v, gradient^2> (second order through each
    collective's backward)."""
    from viscoin_tpu_torch.parallel import spatial as S

    rows = sp.rows(inp["x"].shape[2])
    xg = x.clone().requires_grad_(True)
    s = S.scatter_rows(S.gather_rows(xg, sp) ** 2 * inp["u"][0], sp)
    m = S.model_sum((s * xg).sum(dim=(2, 3)), sp)
    loss = (m ** 2).sum()
    (g,) = torch.autograd.grad(loss, xg, create_graph=True)
    (h,) = torch.autograd.grad((g ** 2 * inp["v"][:, :, rows]).sum(), xg)
    return {"loss": loss.detach(), "g": g.detach(), "h": h}


def _mbstd_rows(inp: dict, mesh, sp) -> dict:
    """The minibatch stddev (groups of 4 over the data axis's batch, the
    mean over (C, H, W) a model-group sum) on this rank's samples and rows,
    and the gradient of a weighted sum of squares through it."""
    from viscoin_tpu_torch.models.stylegan import MinibatchStdLayer

    x = _rows(inp["mbstd_x"], mesh)
    x = x[:, :, sp.rows(x.shape[2])].clone().requires_grad_(True)
    y = MinibatchStdLayer(group_size=4)(x, mesh, sp=sp)
    w = _rows(inp["mbstd_w"], mesh)
    (g,) = torch.autograd.grad((y ** 2 * w[:, :, sp.rows(w.shape[2])]).sum(), x)
    return {"y": y.detach(), "g": g}


def _ada_rows(inp: dict, sp) -> dict:
    """The ADA pipe on this rank's rows of square images (every rank the
    same draws), and the gradient of a weighted sum through it."""
    from viscoin_tpu_torch.train.augment import augment

    x = inp["ada_x"][:, :, sp.rows(inp["ada_x"].shape[2])].clone().requires_grad_(True)
    y = augment(x, inp["ada_p"], inp["ada_draws"], sp=sp)
    u = inp["ada_u"][:, :, sp.rows(inp["ada_u"].shape[2])]
    (g,) = torch.autograd.grad((y * u).sum(), x)
    return {"y": y.detach(), "g": g}


def _disc_rows(inp: dict, mesh, sp) -> dict:
    """The discriminator on this rank's samples and rows, under the natural
    plan and under one whose 8² and 4² planes are whole (b16's output
    gathered): the logits, and the input's gradient of their sum (R1's)."""
    from viscoin_tpu_torch.parallel import spatial as S

    d = inp["disc"]
    out = {}
    for label, plan in (("plan", sp.plan), ("gathered", {**sp.plan, "d.8": False,
                                                         "d.4": False})):
        x = _rows(inp["disc_x"], mesh)
        x = x[:, :, sp.rows(x.shape[2])].clone().requires_grad_(True)
        logits = d(x, mesh, spatial=S.Spatial(axis=sp.axis, plan=plan))
        (g,) = torch.autograd.grad(logits.sum(), x)
        out[label] = {"logits": logits.detach(), "g": g}
    return out


def run_mp_reconstruct(inp: dict, mesh) -> dict:
    """``GeneratorAdapted`` (constant noise) on this rank's samples of Phi and
    Phi': this rank's rows of the images."""
    from viscoin_tpu_torch.parallel.spatial import bundle_spatial

    gan = inp["models"].gan
    sp = bundle_spatial(inp["models"], mesh, gan.img_resolution)
    with torch.no_grad():
        img = gan(_rows(inp["phi"], mesh), _rows(inp["phi_prime"], mesh), noise_mode="const",
                  spatial=sp)
    return {"img": img, "rows": sp.rows(gan.img_resolution)}


def run_mp_step(inp: dict, mesh, fault: str | None = None) -> dict:
    """One fp32 VisCoIN step (float inputs, external fakes, the global
    dropout mask's rows of this rank's samples) on this rank's samples and H
    rows: the metrics, the gradients (from the Adams' first moments) and the
    updated parameters. ``fault``, a planted one: "halo" (every halo filled
    with zeros) or "grads" (the gradients averaged over the data axis
    only)."""
    import torch.nn.functional as F

    from viscoin_tpu_torch.parallel import spatial as S
    from viscoin_tpu_torch.train import viscoin as T

    models, lpips = inp["models"], inp["lpips"]
    cfg = T.VisCoINTrainingParams(**inp["cfg"])
    frozen = T.make_frozen(models, None, lpips, cfg.compute_dtype)
    state = T.create_train_state(models, cfg)
    step = T.make_train_step(models, None, lpips, cfg, preprocess=False, external_fakes=True,
                             mesh=mesh)
    halo, reduce = S.halo_exchange, T.all_reduce_grads
    if fault == "halo":
        S.halo_exchange = lambda x, top, bottom, sp, fill=0.0: F.pad(x, (0, 0, top, bottom))
    elif fault == "grads":
        T.all_reduce_grads = lambda grads, mesh: reduce(grads, mesh.data_axis)
    B = inp["real"].shape[0]
    mask = torch.cat([_rows(inp["mask"][:B], mesh), _rows(inp["mask"][B:], mesh)])
    S.reset_counts()
    try:
        state, metrics = step(state, frozen, _image_rows(inp["real"], mesh),
                              _rows(inp["labels"], mesh), torch.Generator().manual_seed(0),
                              _image_rows(inp["fake"], mesh), dropout_mask=mask)
    finally:
        S.halo_exchange, T.all_reduce_grads = halo, reduce
    grads = {f"{g}.{n}": opt.state[p]["exp_avg"] / 0.1 for opt in (state.opt, state.gan_opt)
             for g, grp in state.params.items() for n, p in grp.items() if p in opt.state}
    params = {f"{g}.{n}": p.detach().clone() for g, grp in state.params.items()
              for n, p in grp.items()}
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
            "params": params, "counts": S.counts()}


def run_mp_gan_steps(inp: dict, mesh, fault: str | None = None) -> dict:
    """GAN steps on this rank's samples and H rows of the global images and
    draws (``inp["draws"]``, one per step, from the global batch: each
    rank's from :meth:`GANStepDraws.shard`), constant synthesis noise: each
    step's metrics, both networks' gradients (the Adams' first moments,
    beta1 = 0: the gradients averaged over the ranks), the parameters after
    the last step and the spatial collectives per step. ``fault``, a planted
    one: "ppl" (the path-length gradient left un-reduced over the model
    group)."""
    from viscoin_tpu_torch.parallel import spatial as S
    from viscoin_tpu_torch.train import gan as TG

    g, d = inp["g"], inp["d"]
    const_noise(g)
    cfg = TG.GANTrainingParams(**inp["cfg"])
    state = TG.create_gan_train_state(g, d, cfg)
    step = TG.make_gan_train_step(g, d, cfg, mesh)
    whole = TG.whole_ws_grads
    if fault == "ppl":
        TG.whole_ws_grads = lambda partial, sp: partial
    out: dict = {"metrics": [], "grads": [], "counts": []}
    try:
        for images, draws in zip(inp["images"], inp["draws"]):
            if mesh is not None:
                images = _rows(images, mesh)
                axis = mesh.model_axis
                images = images[:, axis.rows(axis.local(images.shape[1]))]
                draws = draws.shard(mesh)
            S.reset_counts()
            _, metrics = step(state, images, draws)
            out["counts"].append(S.counts())
            out["metrics"].append({k: float(v) for k, v in metrics.items()})
            out["grads"].append({f"{who}.{n}": opt.state[p]["exp_avg"].clone()
                                 for who, module, opt in (("G", g, state.g_opt),
                                                          ("D", d, state.d_opt))
                                 for n, p in module.named_parameters()})
    finally:
        TG.whole_ws_grads = whole
    out.update(g=state.generator.state_dict(), d=state.discriminator.state_dict())
    return out


def run_mp_eval(inp: dict, mesh) -> dict:
    """``test_viscoin`` with FID (the tiny detector of tests/test_eval.py)
    over the synthetic test set, each data shard its loader shard, each
    model rank its H rows; and the faithfulness probe on ``probe_images``."""
    from viscoin_tpu_torch.data.datasets import SyntheticDataset
    from viscoin_tpu_torch.data.loader import DataLoader
    from viscoin_tpu_torch.eval import viscoin as TE

    data = mesh.data_axis
    loader = DataLoader(SyntheticDataset(n=inp["n"], n_classes=inp["n_classes"],
                                         image_size=inp["size"], mode="test"),
                        inp["batch"], shuffle=False, num_threads=0,
                        shard=(data.rank, data.world), pad_final=True)

    def detector(x):
        return torch.cat([x.mean(dim=(2, 3)), x.std(dim=(1, 2, 3), unbiased=False)[:, None]],
                         dim=1)

    res = TE.test_viscoin(inp["models"], inp["lpips"], loader, compute_fid=True,
                          fid_detector=detector, mesh=mesh)
    probe = TE.make_faithfulness_fn(inp["models"], mesh)(inp["probe_images"])
    return {"results": res.__dict__, "probe": probe}


# -------------------------------- the GAN step -------------------------------- #


def run_gan_steps(inp: dict, mesh: Mesh | None, skip_grad_reduce: bool = False) -> dict:
    """The GAN step at steps ``inp["steps"]`` (set on the state's counter:
    R1 and the path length, plain, the ADA adjustment, the path length),
    with constant synthesis noise and each rank's rows of the global draws:
    every step's metrics, then G, D, the EMA, both Adams' first moments
    (beta1 = 0: the last step's averaged gradients), w_avg, pl_mean and the
    ADA state. ``skip_grad_reduce``: a planted fault, the gradients not averaged
    over the ranks."""
    from viscoin_tpu_torch.train import gan as TG

    g, d = inp["g"], inp["d"]
    const_noise(g)
    cfg = TG.GANTrainingParams(**inp["cfg"])
    state = TG.create_gan_train_state(g, d, cfg)
    step = TG.make_gan_train_step(g, d, cfg, mesh)
    if skip_grad_reduce:
        TG.all_reduce_grads = lambda grads, mesh: grads
    out: dict = {"metrics": []}
    for j, i in enumerate(inp["steps"]):
        state.step = i
        draws = TG.draw_step(cfg, g, 7, i, inp["images"].device, mesh)
        _, metrics = step(state, _rows(inp["images"][j], mesh), draws)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
    out.update(g=state.generator.state_dict(), d=state.discriminator.state_dict(),
               g_ema=state.g_ema.state_dict(), w_avg=state.w_avg.clone(),
               exp_avg={f"{who}.{n}": opt.state[p]["exp_avg"].clone()
                        for who, module, opt in (("G", g, state.g_opt), ("D", d, state.d_opt))
                        for n, p in module.named_parameters()},
               pl_mean=float(state.pl_mean), ada_p=float(state.ada_p),
               ada_rt=float(state.ada_rt))
    return out


def run_gan_counts(inp: dict, mesh: Mesh | None) -> dict:
    """The GAN step at each of ``inp["steps"]``, each alone between a reset
    and a read of the counted collectives: the counts per step, and the
    bytes of G's and D's parameters (the gradients a step averages)."""
    from viscoin_tpu_torch.parallel import mesh as M
    from viscoin_tpu_torch.train import gan as TG

    g, d = inp["g"], inp["d"]
    cfg = TG.GANTrainingParams(**inp["cfg"])
    state = TG.create_gan_train_state(g, d, cfg)
    step = TG.make_gan_train_step(g, d, cfg, mesh)
    counts = []
    for j, i in enumerate(inp["steps"]):
        state.step = i
        draws = TG.draw_step(cfg, g, 7, i, inp["images"].device, mesh)
        M.reset_collective_counts()
        step(state, _rows(inp["images"][j], mesh), draws)
        counts.append(dict(M.collective_counts()))
    return {"counts": counts, "w_dim": g.w_dim,
            "param_bytes": {who: sum(p.numel() * p.element_size() for p in m.parameters())
                            for who, m in (("G", g), ("D", d))}}


def gan_inputs() -> dict:
    """The GAN scenario at toy widths (32², z 8, w 16, channel_base 256,
    channel_max 16, mbstd group 4, global batch 8; ADA at p = 0.2 with a
    short horizon, so that step 3 adjusts it), its weights perturbed."""
    from viscoin_tpu_torch.models.bundle import init_models
    from viscoin_tpu_torch.models.stylegan import Discriminator, Generator

    g = init_models(Generator(z_dim=8, w_dim=16, img_resolution=32, mapping_layers=2,
                              channel_base=256, channel_max=16, device="cpu"), 3)
    d = init_models(Discriminator(img_resolution=32, channel_base=256, channel_max=16,
                                  mbstd_group_size=4, device="cpu"), 4)
    rng = np.random.default_rng(21)
    with torch.no_grad():  # non-zero biases, constants and noise strengths
        for module in (g, d):
            for p in module.parameters():
                p.add_(0.05 * torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
    steps = (0, 1, 3, 4)
    return dict(g=g, d=d, steps=steps,
                cfg=dict(batch_size=8, augment_p=0.2, ada_interval=4, ada_kimg=0.1,
                         ema_kimg=0.01, style_mixing_prob=0.5),
                images=torch.from_numpy(rng.integers(0, 256, (len(steps), 8, 32, 32, 3),
                                                     dtype=np.uint8)))


def relative(got, want) -> float:
    """max |got - want| / max |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-12))


def gan_deviation(outs: list[dict], ref: dict, key: str) -> dict[str, float]:
    """The largest deviation over the ranks of scenario ``key``'s GAN run
    from the one-process run ``ref``: every step's metrics (relative, at
    least 1e-3 absolute), each G, D and EMA tensor, each first moment and
    w_avg (of its scale), pl_mean and the ADA state."""
    dev: dict[str, float] = {}

    def put(name, value):
        dev[name] = max(dev.get(name, 0.0), value)

    for out in outs:
        got = out[key]
        for j, (m, w) in enumerate(zip(got["metrics"], ref["metrics"])):
            for k in w:
                put(f"metric {j} {k}", abs(m[k] - w[k]) / max(abs(w[k]), 1e-3))
        for n, t in ref["exp_avg"].items():
            put(f"exp_avg {n}", relative(got["exp_avg"][n], t))
        for part in ("g", "d", "g_ema"):
            for n, t in ref[part].items():
                if t.is_floating_point():
                    put(f"{part}.{n}", relative(got[part][n], t))
        put("w_avg", relative(got["w_avg"], ref["w_avg"]))
        for k in ("pl_mean", "ada_p", "ada_rt"):
            put(k, abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-3))
    return dev


# ----------------------------- the classifier step ---------------------------- #


def classifier_inputs() -> dict:
    """Two classifier steps at toy widths (a 4-stage ResNet of width 8-64,
    5 classes, 32², global batch 8) with their flips."""
    from viscoin_tpu_torch.models.bundle import init_models
    from viscoin_tpu_torch.models.resnet import Classifier

    rng = np.random.default_rng(31)
    model = init_models(Classifier(output_classes=5, embedding_size=8,
                                   hidden_sizes=(8, 16, 32, 64), depths=(1, 1, 1, 1),
                                   device="cpu"), 5)
    return dict(model=model,
                images=torch.from_numpy(rng.integers(0, 256, (2, 8, 32, 32, 3), dtype=np.uint8)),
                labels=torch.from_numpy(rng.integers(0, 5, (2, 8))),
                flips=torch.from_numpy(rng.random((2, 8)) < 0.5))


def run_classifier_steps(inp: dict, mesh: Mesh | None) -> dict:
    """Two classifier steps (BatchNorm in train mode) with the global
    flips' rows: losses, counts of correct predictions, the parameters and
    the running statistics."""
    from viscoin_tpu_torch.train import classifiers as TC

    model = inp["model"]
    params = TC.ClassifierTrainingParams(batch_size=inp["images"].shape[1])
    state = TC.create_classifier_state(model, params, steps_per_epoch=10)
    step = TC.make_classifier_train_step("float32", mesh)
    losses = []
    for j in range(inp["images"].shape[0]):
        loss, correct = step(state, _rows(inp["images"][j], mesh), _rows(inp["labels"][j], mesh),
                             _rows(inp["flips"][j], mesh))
        losses.append((float(loss), float(correct)))
    return {"losses": losses, "state": model.state_dict()}


# ---------------------------- the sharded evaluation -------------------------- #


def run_test_viscoin(inp: dict, mesh: Mesh | None) -> dict:
    """``test_viscoin`` with FID (a fixed linear detector) over a test set
    whose last global batch is ragged (the shards padded by ``pad_final``),
    and the faithfulness probe over the ranks."""
    from viscoin_tpu_torch.data.datasets import SyntheticDataset
    from viscoin_tpu_torch.data.loader import DataLoader
    from viscoin_tpu_torch.eval import viscoin as TE

    models, lpips, proj = inp["models"], inp["lpips"], inp["proj"]
    shard = (0, 1) if mesh is None else (mesh.rank, mesh.world)
    loader = DataLoader(SyntheticDataset(n=inp["n"], n_classes=inp["n_classes"],
                                         image_size=inp["size"], mode="test"),
                        inp["batch"], shuffle=False, num_threads=0, shard=shard,
                        pad_final=shard[1] > 1)  # as data/utils.py::get_dataloaders

    def detector(x):
        return x.reshape(x.shape[0], -1) @ proj

    res = TE.test_viscoin(models, lpips, loader, compute_fid=True, fid_detector=detector,
                          mesh=mesh)
    probe = TE.make_faithfulness_fn(models, mesh)(inp["probe_images"])
    return {"results": res.__dict__, "probe": probe}


def run_gan_fid(inp: dict, mesh: Mesh | None) -> dict:
    """``train gan``'s in-loop FID statistics with a fixed linear detector:
    the real side over the dataset's batches in order (each rank its
    shard), the fake side from the EMA generator (each rank its rows of
    every batch's latents; constant synthesis noise): both sides' means,
    covariances and counts, and the FID."""
    from viscoin_tpu_torch.data.datasets import SyntheticDataset
    from viscoin_tpu_torch.eval.fid import fid_from_stats
    from viscoin_tpu_torch.train import gan as TG

    g = inp["g"].eval().requires_grad_(False)
    const_noise(g)
    proj = inp["proj"]

    def detector(x):
        return x.reshape(x.shape[0], -1) @ proj

    fake_fn, real_fn = TG.make_gan_fid_fns(inp["batch"], mesh)
    ds = SyntheticDataset(n=inp["n"], image_size=g.img_resolution, mode="train",
                          transform="gan")
    real = TG.accumulate_real_fid_stats(detector, real_fn, ds, inp["batch"], inp["samples"],
                                        device=proj.device, mesh=mesh)
    fake = TG.accumulate_fake_fid_stats(detector, fake_fn, g, 11, inp["samples"], mesh=mesh)
    return {"real": (*real.get_mean_cov(), real.num_items),
            "fake": (*fake.get_mean_cov(), fake.num_items), "fid": fid_from_stats(real, fake)}


# ---------------------------------- the command ------------------------------- #


def run_command(inp: dict, mesh: Mesh | None) -> dict:
    """``python -m viscoin_tpu_torch train viscoin`` (its ``main``) at toy
    widths in this rank's own working directory, then its resume from rank
    0's training state; the group is the command's own (WORLD_SIZE set).
    ``inp``: "argv" more options, "epochs" (first run, resume), else (3, 4)."""
    from viscoin_tpu_torch.__main__ import main
    from viscoin_tpu_torch.cli import train as cli_train
    from viscoin_tpu_torch.models import bundle as tb
    from viscoin_tpu_torch.models.concept_extractor import ConceptExtractor
    from viscoin_tpu_torch.models.explainer import Explainer
    from viscoin_tpu_torch.models.lpips import LPIPS
    from viscoin_tpu_torch.models.resnet import Classifier
    from viscoin_tpu_torch.models.stylegan import Generator, GeneratorAdapted

    def toy_modules(n_classes, size, device="cuda"):
        models = tb.VisCoINModels(
            classifier=Classifier(**dict(inp["classifier"], output_classes=n_classes),
                                  device=device),
            concept_extractor=ConceptExtractor(**inp["psi"], device=device),
            explainer=Explainer(n_concepts=inp["psi"]["n_concepts"], n_classes=n_classes,
                                device=device),
            gan=GeneratorAdapted(**dict(inp["gan"], img_resolution=size), device=device))
        generator = Generator(z_dim=16, w_dim=32, img_resolution=size, channel_base=256,
                              channel_max=16, mapping_layers=2, device=device)
        return (tb.init_models(models, 0), tb.init_models(generator, 1),
                tb.init_models(LPIPS(device=device), 2))

    cli_train.build_viscoin_modules = toy_modules
    rank = int(os.environ["RANK"])
    work = os.path.join(inp["dir"], f"rank{rank}")
    os.makedirs(work, exist_ok=True)
    os.chdir(work)
    os.environ.update(VISCOIN_SYNTH_N="8", VISCOIN_SYNTH_SIZE="32")
    base = ["train", "viscoin", "--device", "cpu", "--dataset", "synthetic", "--batch-size", "4",
            "--eval-every", "1", "--checkpoint-every", "2", "--faithfulness-every", "2",
            "--prefetch", "0", *inp.get("argv", [])]
    first_epochs, resume_epochs = inp.get("epochs", (3, 4))
    os.environ["MASTER_PORT"] = str(inp["ports"][0])
    rcs = [main([*base, "--epochs", str(first_epochs)])]
    first = sorted(os.listdir(work))
    os.environ["MASTER_PORT"] = str(inp["ports"][1])  # a new group for the resume
    rcs.append(main([*base, "--epochs", str(resume_epochs), "--resume",
                     os.path.join(inp["dir"], "rank0", "train_state")]))
    return {"rcs": rcs, "first": first, "files": sorted(os.listdir(work))}


def run_gan_command(inp: dict, mesh: Mesh | None) -> dict:
    """``python -m viscoin_tpu_torch train gan`` (its ``main``) with
    ``inp["argv"]`` at toy widths (``inp["g"]``, ``inp["d"]``: the
    generator's and discriminator's options) on the synthetic dataset at
    ``inp["size"]``², each rank in its own working directory: run A for
    ``inp["epochs"][0]`` iterations, run B resumed from rank 0's state of A
    to ``inp["epochs"][1]``, and run C unbroken to there (in rank<r>_c); the
    group is each run's own (WORLD_SIZE set, a port per run). Returns the
    exit codes, the files of each directory and rank 0's states of B and C."""
    from viscoin_tpu_torch.__main__ import main
    from viscoin_tpu_torch.cli import train as cli_train
    from viscoin_tpu_torch.models import bundle as tb
    from viscoin_tpu_torch.models.stylegan import Discriminator, Generator

    def toy_gan_modules(size, channel_base, channel_max, batch_size, device="cuda", seed=0):
        g = Generator(img_resolution=size, **inp["g"], device=device)
        d = Discriminator(img_resolution=size, **inp["d"], mbstd_group_size=min(4, batch_size),
                          device=device)
        return tb.init_models(g, seed), tb.init_models(d, seed + 1)

    cli_train.build_gan_modules = toy_gan_modules
    rank = int(os.environ["RANK"])
    work = os.path.join(inp["dir"], f"rank{rank}")
    unbroken = os.path.join(inp["dir"], f"rank{rank}_c")
    for d in (work, unbroken):
        os.makedirs(d, exist_ok=True)
    os.environ.update(VISCOIN_SYNTH_N="8", VISCOIN_SYNTH_SIZE=str(inp["size"]))
    base = ["train", "gan", "--device", "cpu", "--dataset", "synthetic", "--batch-size", "4",
            "--compute-dtype", "float32", "--output-weights", "gan", *inp["argv"]]
    first, last = inp["epochs"]
    rcs = []
    for port, cwd, args in (
            (inp["ports"][0], work, ["--epochs", str(first)]),
            (inp["ports"][1], work, ["--epochs", str(last), "--resume",
                                     os.path.join(inp["dir"], "rank0", "gan.train_state")]),
            (inp["ports"][2], unbroken, ["--epochs", str(last)])):
        os.chdir(cwd)
        os.environ["MASTER_PORT"] = str(port)
        rcs.append(main([*base, *args]))
    out = {"rcs": rcs, "files": sorted(os.listdir(work)), "files_c": sorted(os.listdir(unbroken))}
    if rank == 0:
        out["states"] = [torch.load(os.path.join(d, "gan.train_state", "train_state.pt"),
                                    weights_only=True) for d in (work, unbroken)]
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def to_device(obj, device):
    """``obj`` (tensors and modules, in dicts, lists and tuples) on ``device``."""
    if isinstance(obj, (torch.Tensor, torch.nn.Module)):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(v, device) for v in obj)
    return obj


class Ranks:
    """``world`` worker processes over gloo (each with a one-thread torch) on
    ``device``, running the scenarios of ``inputs`` (written first); started
    at once, so that the caller can work while they run. :meth:`join`
    returns, per rank, {scenario: its output}, on the CPU. Every wait is
    bounded: a hang kills the workers and fails."""

    def __init__(self, work_dir, inputs: dict[str, dict], world: int = 2,
                 device: str = "cpu"):
        import subprocess
        from pathlib import Path

        self.work_dir, self.names, self.world = Path(work_dir), list(inputs), world
        for name, inp in inputs.items():
            torch.save(inp, self.work_dir / f"{name}.in.pt")
        repo = str(Path(__file__).resolve().parent.parent)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
        port = str(free_port())
        self.procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world), port,
                                        str(self.work_dir), device, *inputs], env=env,
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True) for r in range(world)]

    def join(self, timeout: float = 120.0) -> list[dict]:
        import time

        logs, t0 = [], time.monotonic()
        try:
            for p in self.procs:
                left = max(1.0, timeout - (time.monotonic() - t0))
                logs.append(p.communicate(timeout=left)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate(timeout=30)
        for r, (p, log) in enumerate(zip(self.procs, logs)):
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
        return [{name: torch.load(self.work_dir / f"{name}.rank{r}.pt", weights_only=False,
                                  map_location="cpu")
                 for name in self.names} for r in range(self.world)]


def run_ranks(work_dir, inputs: dict[str, dict], world: int = 2, timeout: float = 120.0,
              device: str = "cpu") -> list[dict]:
    """Write each scenario's inputs, run ``world`` worker processes over
    gloo (each with a one-thread torch) on ``device`` and return, per rank,
    {scenario: its output}, on the CPU. Every wait is bounded by
    ``timeout`` seconds: a hang kills the workers and fails."""
    return Ranks(work_dir, inputs, world, device).join(timeout)


def main(argv: list[str]) -> int:
    rank, world, port, out_dir, device, *scenarios = argv
    os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank, MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=port)
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False  # the card's runs are held to the fp32 reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    np.random.seed(0)
    for name in scenarios:
        inp = to_device(torch.load(os.path.join(out_dir, f"{name}.in.pt"), weights_only=False),
                        device)
        if name in ("command", "gan_command"):  # the command joins and leaves the group
            out = globals()[f"run_{name}"](inp, None)
        else:
            mesh = (make_mesh_2d(*inp["mesh2d"], device, backend="gloo") if "mesh2d" in inp
                    else make_mesh(device, backend="gloo"))
            fn = globals()[f"run_{inp.get('fn', name)}"]
            out = fn(inp, mesh, **inp.get("kw", {}))
        torch.save(out, os.path.join(out_dir, f"{name}.rank{rank}.pt"))
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
