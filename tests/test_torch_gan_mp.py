"""The mixed-precision StyleGAN2-ADA of the port (``num_fp16_res``,
``conv_clamp``, the mapping depth, ``pl_batch_shrink``, the gradient
sanitizer, ``GAN_PRESETS``, ``train gan --cfg``) against the benchmark's
plain reference ``perfbench/reference/stylegan_mp.py`` on seeded random
weights at a toy size (32², channel_base 256, mapping 8), on the CPU."""

import copy

import pytest
import torch

from perfbench.harness import weights
from perfbench.reference import stylegan_mp as SM
from perfbench.reference.steps import GANHyper, draw_gan_step
from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from viscoin_tpu_torch.__main__ import main
from viscoin_tpu_torch.cli import train as cli_train
from viscoin_tpu_torch.models.bundle import init_models
from viscoin_tpu_torch.models.stylegan import Discriminator, Generator
from viscoin_tpu_torch.train import gan as T
from viscoin_tpu_torch.utils import checkpoints as ckpt
from viscoin_tpu_torch.utils import tracing

TOY = dict(resolution=32, z_dim=16, w_dim=16, mapping_layers=8, channel_base=256, channel_max=16,
           mbstd_group=4, num_fp16_res=2, conv_clamp=256.0)
SEED = 2**33 + 19
B = 4


def sizes(**kw) -> dict:
    return {**TOY, **kw}


def port(s: dict, device="cpu"):
    """The port's G and D with the reference's seeded weights."""
    g = Generator(z_dim=s["z_dim"], w_dim=s["w_dim"], img_resolution=s["resolution"],
                  channel_base=s["channel_base"], channel_max=s["channel_max"],
                  mapping_layers=s["mapping_layers"], conv_clamp=s["conv_clamp"],
                  num_fp16_res=s["num_fp16_res"], device=device)
    d = Discriminator(img_resolution=s["resolution"], channel_base=s["channel_base"],
                      channel_max=s["channel_max"], mbstd_group_size=s["mbstd_group"],
                      conv_clamp=s["conv_clamp"], num_fp16_res=s["num_fp16_res"], device=device)
    st = weights.make_states(SM.factories(s), SEED, device)
    return weights.load(g, st["G"]), weights.load(d, st["D"])


def reference(s: dict, low_dtype=torch.float32, device="cpu"):
    fac = SM.factories(s, low_dtype)
    st = weights.make_states(SM.factories(s), SEED, device)
    return (weights.load(weights.build(fac["G"], device), st["G"]),
            weights.load(weights.build(fac["D"], device), st["D"]))


def forwards(g, d):
    """G's image of seeded latents and noise, and D's logits of it."""
    z = torch.randn(B, TOY["z_dim"], generator=torch.Generator().manual_seed(3))
    noise = torch.Generator().manual_seed(5)
    if isinstance(g, Generator):
        img = g(z, noise_mode="random", generator=noise)
    else:
        img = g(z, "random", noise)
    return img, d(img.detach())


def rel(got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max())


def test_forward_at_fp32_with_a_biting_clamp_matches_the_reference():
    """num_fp16_res 0 and a clamp of 0.25 · gain (most activations clamped):
    G's image and D's logits equal the reference's to fp32 rounding, and
    differ from those without the clamp."""
    s = sizes(num_fp16_res=0, conv_clamp=0.25)
    (img, logits), (rimg, rlogits) = forwards(*port(s)), forwards(*reference(s))
    assert rel(img, rimg) < 1e-5 and rel(logits, rlogits) < 1e-5
    unclamped = forwards(*reference(sizes(num_fp16_res=0, conv_clamp=None)))
    assert rel(rimg, unclamped[0]) > 1e-2 and rel(rlogits, unclamped[1]) > 1e-2


def test_forward_with_fp16_blocks_within_fp16_rounding_and_bf16_is_not():
    """Two float16 blocks in each network (16² and 32²): the image and the
    logits within 3e-3 of their scale of the all-float32 reference (a few
    float16 units, 2^-10 each, through four layers); the reference with
    those blocks in bfloat16 (2^-7 a unit) is off by more."""
    s = sizes()
    (img, logits), (rimg, rlogits) = forwards(*port(s)), forwards(*reference(s))
    low_img, low_logits = forwards(*reference(s, torch.bfloat16))
    tol = 3e-3
    assert rel(img, rimg) < tol and rel(logits, rlogits) < tol
    assert max(rel(low_img, rimg), rel(low_logits, rlogits)) > tol


def test_block_dtypes_and_the_rgb_image():
    """G's 4² and 8² blocks run in float32, 16² and 32² in float16, and
    return x in float16 and the image in float32; D's 32² and 16² blocks in
    float16, its 8² block and epilogue in float32; each call counted."""
    s = sizes()
    g, d = port(s)
    tracing.reset_precision_counts()
    ws = g.mapping(torch.randn(B, 16, generator=torch.Generator().manual_seed(1)))
    x = img = None
    for res in g.synthesis.block_resolutions:
        block = getattr(g.synthesis, f"b{res}")
        x, img = block(x, img, ws[:, :block.num_conv + 1], generator=torch.Generator())
        assert x.dtype == (torch.float16 if res >= 16 else torch.float32), res
        assert img.dtype == torch.float32
    y = d.b32(None, img)
    assert y.dtype == torch.float16 and d.b16(y, None).dtype == torch.float16
    assert d(img).dtype == torch.float32
    counts = tracing.precision_counts()
    assert counts["blocks.fp16.g16"] == counts["blocks.fp16.g32"] == 1
    assert counts["blocks.fp32.g4"] == counts["blocks.fp32.g8"] == 1
    assert counts["blocks.fp16.d32"] == 2 and counts["blocks.fp32.d8"] == 1
    assert counts["blocks.fp16"] == 6 and counts["blocks.fp32"] == 3
    _, d0 = port(sizes(num_fp16_res=0))
    tracing.reset_precision_counts()
    d0(img)
    assert tracing.precision_counts()["blocks.fp32"] == 3


def _port_step(s: dict, lr: float, steps: int):
    g, d = port(s)
    cfg = T.GANTrainingParams(batch_size=B, learning_rate=lr, r1_gamma=2.0, augment="ada",
                              augment_p=0.3, pl_batch_shrink=2, compute_dtype="float32")
    state = T.create_gan_train_state(g, d, cfg)
    step = T.make_gan_train_step(g, d, cfg)
    images = torch.randint(0, 256, (B, 32, 32, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(9))
    out = []
    for i in range(steps):
        _, m = step(state, images, T.draw_step(cfg, g, SEED, i, "cpu"))
        out.append({k: float(v) for k, v in m.items()})
    grads = {f"G.{n}": state.g_opt.state[p]["exp_avg"] for n, p in g.named_parameters()}
    grads.update({f"D.{n}": state.d_opt.state[p]["exp_avg"] for n, p in d.named_parameters()})
    return out, grads, images


def _reference_step(s: dict, lr: float, steps: int, images):
    g, d = reference(s)
    h = GANHyper(lr=lr, r1_gamma=2.0)
    ref = SM.GANReferenceMP(g, d, copy.deepcopy(g), h, 0.3, pl_batch_shrink=2)
    out = []
    for i in range(steps):
        out.append(ref.step(images, draw_gan_step(h, B, s["z_dim"], s["resolution"], SEED, i,
                                                  "cpu")))
    return out, ref.first_grads()


def test_a_train_step_cycle_matches_the_reference_leaf_by_leaf():
    """fp32 blocks, clamp 256, mapping 8, path length on half the batch, R1
    gamma 2: the R1 + path-length step 0 and the plain step 1 through
    make_gan_train_step against the reference: the losses, R1 and the path
    lengths within 1e-4, every gradient leaf of the first update within
    1e-3 of its largest element (lr 0, so both D phases see one G)."""
    s = sizes(num_fp16_res=0)
    got, grads, images = _port_step(s, 0.0, 2)
    want, rgrads = _reference_step(s, 0.0, 2, images)
    for g_, w_ in zip(got, want):
        for k in ("g_loss", "d_loss", "r1", "pl_lengths"):
            assert abs(g_[k] - w_[k]) <= 1e-4 * max(abs(w_[k]), 1e-3), (k, g_[k], w_[k])
    assert got[0]["r1"] > 0 and got[0]["pl_lengths"] > 0
    assert set(grads) == set(rgrads)
    for n, w in rgrads.items():
        scale = float(w.abs().max())
        assert float((grads[n] - w).abs().max()) <= 1e-3 * max(scale, 1e-12), n


def test_the_path_length_runs_on_the_first_rows(monkeypatch):
    """pl_batch_shrink 2 at batch 4: the penalty sees the draws' first two
    latents and projection images."""
    seen = {}
    orig = T.make_gan_loss_fns

    def spy(*args, **kwargs):
        fns = dict(orig(*args, **kwargs))
        pl = fns["ppl_penalty"]

        def ppl(g_params, z, noise_seed, pl_y, pl_mean):
            seen.update(z=z.clone(), pl_y=pl_y.clone())
            return pl(g_params, z, noise_seed, pl_y, pl_mean)

        fns["ppl_penalty"] = ppl
        return fns

    monkeypatch.setattr(T, "make_gan_loss_fns", spy)
    s = sizes(num_fp16_res=0, mapping_layers=2)
    g, d = port(s)
    cfg = T.GANTrainingParams(batch_size=B, pl_batch_shrink=2, augment="none",
                              compute_dtype="float32")
    state = T.create_gan_train_state(g, d, cfg)
    draws = T.draw_step(cfg, g, SEED, 0, "cpu")
    T.make_gan_train_step(g, d, cfg)(state, torch.zeros(B, 32, 32, 3, dtype=torch.uint8), draws)
    assert torch.equal(seen["z"], draws.zp[:2]) and torch.equal(seen["pl_y"], draws.pl_y[:2])


def test_the_sanitizer_replaces_non_finite_gradients_and_counts_them():
    """stylegan2-ada-pytorch's nan_to_num(nan=0, posinf=1e5, neginf=-1e5),
    one pass over the gradients flattened, each leaf's shape kept; the
    replaced elements counted on the device."""
    a = torch.tensor([[1.0, float("inf")], [float("nan"), -2.0]])
    b = torch.tensor([float("-inf"), 3.0, 4.0])
    tracing.reset_precision_counts()
    out = T._sanitized([a, b])
    assert torch.equal(out[0], torch.tensor([[1.0, 1e5], [0.0, -2.0]]))
    assert torch.equal(out[1], torch.tensor([-1e5, 3.0, 4.0]))
    T._sanitized([torch.ones(3)])
    assert tracing.precision_counts()["grad_nonfinite"] == 3


def test_a_planted_inf_in_an_fp16_step_is_replaced_before_adam(monkeypatch):
    """In a step of networks with float16 blocks, a gradient with an inf
    reaches Adam finite (and counted); in an all-float32 step the sanitizer
    does not run."""
    orig = T._grads

    def planted(loss, params):
        grads = orig(loss, params)
        grads[0] = grads[0].contiguous().clone()
        grads[0].view(-1)[0] = float("inf")
        return grads

    monkeypatch.setattr(T, "_grads", planted)
    for n16, replaced in ((2, True), (0, False)):
        s = sizes(num_fp16_res=n16, mapping_layers=2)
        g, d = port(s)
        cfg = T.GANTrainingParams(batch_size=B, augment="none", compute_dtype="float32",
                                  ppl_weight=0.0, r1_gamma=0.0)
        state = T.create_gan_train_state(g, d, cfg)
        tracing.reset_precision_counts()
        T.make_gan_train_step(g, d, cfg)(state, torch.zeros(B, 32, 32, 3, dtype=torch.uint8),
                                         T.draw_step(cfg, g, SEED, 1, "cpu"))
        finite = all(bool(torch.isfinite(p).all()) for p in (*g.parameters(), *d.parameters()))
        assert finite == replaced
        assert tracing.precision_counts().get("grad_nonfinite", 0) == (2 if replaced else 0)


# stylegan2-ada-pytorch train.py: cfg_specs['paper1024'] and the settings every
# cfg takes (args.G_kwargs / D_kwargs / loss_kwargs / G_opt_kwargs / ada_*).
UPSTREAM_PAPER1024 = dict(ref_gpus=8, kimg=25000, mb=32, mbstd=4, fmaps=1, lrate=0.002, gamma=2,
                          ema=10, ramp=None, map=8)
UPSTREAM_FIXED = dict(num_fp16_res=4, conv_clamp=256, r1_interval=16, pl_interval=4,
                      pl_weight=2, pl_batch_shrink=2, pl_decay=0.01, style_mixing_prob=0.9,
                      ada_target=0.6, ada_interval=4, ada_kimg=500, betas=(0, 0.99),
                      w_avg_beta=0.995, z_dim=512, w_dim=512)


def test_the_paper1024_preset_is_upstreams():
    """Every value of the preset table against cfg_specs['paper1024'] and the
    trainer's fixed settings, and the benchmark configuration's sizes."""
    preset = T.GAN_PRESETS["paper1024"]
    m, t, u, f = preset["model"], preset["training"], UPSTREAM_PAPER1024, UPSTREAM_FIXED
    assert preset["ref_gpus"] == u["ref_gpus"] and t["batch_size"] == u["mb"]
    assert m["mbstd_group_size"] == u["mbstd"] and m["mapping_layers"] == u["map"]
    assert (m["channel_base"], m["channel_max"]) == (int(u["fmaps"] * 32768),
                                                      min(int(u["fmaps"] * 32768) // 64, 512))
    assert (t["learning_rate"], t["r1_gamma"], t["ema_kimg"]) == (u["lrate"], u["gamma"], u["ema"])
    assert t["ema_rampup"] == 0.0 and u["ramp"] is None
    assert (m["num_fp16_res"], m["conv_clamp"], m["z_dim"], m["w_dim"]) == (
        f["num_fp16_res"], f["conv_clamp"], f["z_dim"], f["w_dim"])
    assert (t["r1_interval"], t["ppl_interval"], t["ppl_weight"], t["pl_batch_shrink"],
            t["ppl_decay"], t["style_mixing_prob"], t["w_avg_beta"]) == (
        f["r1_interval"], f["pl_interval"], f["pl_weight"], f["pl_batch_shrink"],
        f["pl_decay"], f["style_mixing_prob"], f["w_avg_beta"])
    assert (t["beta1"], t["beta2"]) == f["betas"] and t["compute_dtype"] == "float32"
    assert (t["augment"], t["ada_target"], t["ada_interval"], t["ada_kimg"]) == (
        "ada", f["ada_target"], f["ada_interval"], f["ada_kimg"])
    from perfbench.harness import core

    s = core.load_json(core.config_file("stylegan2ada-1024"))["sizes"]
    assert {k: s[k] for k in ("z_dim", "w_dim", "mapping_layers", "channel_base",
                              "channel_max", "num_fp16_res", "conv_clamp")} == {
        k: m[k] for k in ("z_dim", "w_dim", "mapping_layers", "channel_base", "channel_max",
                          "num_fp16_res", "conv_clamp")}
    assert (s["lr"], s["r1_gamma"], s["ema_kimg"], s["pl_batch_shrink"]) == (
        t["learning_rate"], t["r1_gamma"], t["ema_kimg"], t["pl_batch_shrink"])


def test_refused_combinations(monkeypatch, tmp_path):
    """Float16 blocks with a global bfloat16 cast, and --cfg paper1024 with
    --model-parallel or an explicit --compute-dtype bfloat16, are refused
    with a message."""
    g, d = port(sizes(mapping_layers=2))
    with pytest.raises(ValueError, match="bfloat16"):
        T.make_gan_train_step(g, d, T.GANTrainingParams(batch_size=B, compute_dtype="bfloat16"))
    monkeypatch.chdir(tmp_path)
    base = ["train", "gan", "--device", "cpu", "--dataset", "synthetic", "--cfg", "paper1024"]
    for extra, words in ((["--model-parallel", "2"], "model axis"),
                         (["--compute-dtype", "bfloat16"], "compute-dtype bfloat16")):
        with pytest.raises(SystemExit) as err:
            main([*base, *extra])
        assert err.value.code == 2


def _toy_preset_modules(size, channel_base, channel_max, batch_size, device="cuda", seed=0, *,
                        mapping_layers=2, num_fp16_res=0, conv_clamp=None):
    """``build_gan_modules`` at toy widths, keeping the preset's settings."""
    g = Generator(z_dim=16, w_dim=16, img_resolution=size, channel_base=256, channel_max=16,
                  mapping_layers=mapping_layers, conv_clamp=conv_clamp,
                  num_fp16_res=num_fp16_res, device=device)
    d = Discriminator(img_resolution=size, channel_base=256, channel_max=16,
                      mbstd_group_size=min(4, batch_size), conv_clamp=conv_clamp,
                      num_fp16_res=num_fp16_res, device=device)
    return init_models(g, seed), init_models(d, seed + 1)


def test_train_gan_cfg_paper1024_exports_its_precision(monkeypatch, tmp_path):
    """`train gan --cfg paper1024` (toy widths, 16²) builds the preset's
    networks (8 mapping layers, float16 blocks, clamp 256), trains with its
    parameters, and its export records num_fp16_res and conv_clamp, which
    the generator loader reads back; an export of cfg auto records none
    and loads as before."""
    from viscoin_tpu_torch.cli.utils import load_generator

    built = {}

    def modules(*args, **kwargs):
        built.update(kwargs)
        return _toy_preset_modules(*args, **kwargs)

    monkeypatch.setattr(cli_train, "build_gan_modules", modules)
    monkeypatch.setenv("VISCOIN_SYNTH_N", "8")
    monkeypatch.setenv("VISCOIN_SYNTH_SIZE", "16")
    monkeypatch.chdir(tmp_path)
    assert main(["train", "gan", "--device", "cpu", "--dataset", "synthetic", "--cfg",
                 "paper1024", "--batch-size", "4", "--epochs", "2", "--output-weights",
                 "gan"]) == 0
    assert built == dict(mapping_layers=8, num_fp16_res=4, conv_clamp=256.0)
    tree = ckpt.restore_pytree("gan")
    assert int(tree["config"]["num_fp16_res"]) == 4 and float(tree["config"]["conv_clamp"]) == 256
    g = load_generator("gan", "cpu")
    assert g.num_fp16_res == 4 and g.config["conv_clamp"] == 256.0
    assert g.synthesis.b16.dtype == torch.float16 and g.synthesis.b4.dtype == torch.float32
    monkeypatch.setattr(cli_train, "build_gan_modules", _toy_preset_modules)
    assert main(["train", "gan", "--device", "cpu", "--dataset", "synthetic", "--batch-size",
                 "4", "--epochs", "1", "--compute-dtype", "float32", "--output-weights",
                 "auto"]) == 0
    assert "config" not in ckpt.restore_pytree("auto")
    g = load_generator("auto", "cpu")
    assert g.num_fp16_res == 0 and g.config["conv_clamp"] is None


def _dense_warp(images, mats, v):
    """The warp as JAX's dense per-line interpolation matrices of hat
    weights compute it (pass 1 along y on the sheared lines, pass 2 along
    x), the form the gathered warp replaces."""
    B, C, H, W = images.shape
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    a00, a01 = mats[:, 0, 0, None, None], mats[:, 0, 1, None, None]
    a10, a11 = mats[:, 1, 0, None, None], mats[:, 1, 1, None, None]
    vx, vy = v[:, 0, None, None], v[:, 1, None, None]
    xs = torch.arange(W, dtype=images.dtype)
    ys = torch.arange(H, dtype=images.dtype)
    hat = lambda u: torch.clamp_min(1.0 - u.abs(), 0.0)  # noqa: E731
    syp = ((a10 / a00) * (xs[None, :, None] - cx - vx)
           + ((a00 * a11 - a01 * a10) / a00) * (ys[None, None, :] - cy) + cy + vy)
    tmp = torch.einsum("bxYy,bcyx->bcYx", hat(ys[None, None, None, :] - syp[..., None]), images)
    sx = a00 * (xs[None, None, :] - cx) + a01 * (ys[None, :, None] - cy) + cx + vx
    return torch.einsum("bYXx,bcYx->bcYX", hat(xs[None, None, None, :] - sx[..., None]), tmp)


def test_the_gathered_warp_of_large_planes_is_the_dense_one():
    """The warp gathers the two samples each output reads (a 1024² plane's
    dense interpolation matrices hold 4.3 GB per image and pass): the same
    values, gradients and second order (R1's) as the dense matrices, in
    float64 at 20², rotations, scalings, shears and translations."""
    from viscoin_tpu_torch.train import augment as A

    g = torch.Generator().manual_seed(11)
    img = torch.randn(3, 3, 20, 20, dtype=torch.float64, generator=g).requires_grad_()
    th = torch.rand(3, generator=g, dtype=torch.float64) * 6 - 3
    c, s_ = torch.cos(th), torch.sin(th)
    mats = torch.stack([torch.stack([c * 1.2, -s_ + 0.1], -1), torch.stack([s_, c * 0.9], -1)], -2)
    v = torch.randn(3, 2, generator=g, dtype=torch.float64) * 3
    dy = torch.randn(3, 3, 20, 20, generator=g, dtype=torch.float64).requires_grad_()

    def run(warp):  # the warp, its adjoint, and the adjoint's own gradient (in dy)
        out = warp(img, mats, v)
        (gx,) = torch.autograd.grad((out * dy).sum(), img, create_graph=True)
        (gdy,) = torch.autograd.grad(gx.square().sum(), dy)
        return out, gx, gdy

    for want, got in zip(run(_dense_warp), run(A._warp)):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_fp16_blocks_run_in_their_spans_forward_and_backward():
    """Under a profiler, each float16 block's forward is the span g_fp16 or
    d_fp16, and the backward of what it computed <name>.backward, each
    closed; D's first block on an image that takes no gradient has no
    backward span. Without a profiler nothing is marked."""
    from torch.profiler import ProfilerActivity, profile

    s = sizes(mapping_layers=2)
    g, d = port(s)
    z = torch.randn(B, 16, generator=torch.Generator().manual_seed(2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        img = g(z, noise_mode="random", generator=torch.Generator().manual_seed(3))
        loss = torch.nn.functional.softplus(-d(img)).mean()
        torch.autograd.grad(loss, list(g.parameters()))
        torch.autograd.grad(d(img.detach()).sum(), list(d.parameters()))
    names = [e.name for e in prof.events()]
    # two G and two D blocks in float16: forward each once (D twice), backward
    # for each but D's first block in the second pass (its image needs no grad)
    assert names.count("vt.g_fp16") == 2 and names.count("vt.d_fp16") == 4
    assert names.count("vt.g_fp16.backward") == 2 and names.count("vt.d_fp16.backward") == 3
    assert all(e.time_range.end >= e.time_range.start for e in prof.events()
               if e.name.endswith("fp16.backward"))
    t = torch.ones(2, requires_grad=True)
    region = tracing.fp16_region("g_fp16")
    assert region.enter(t)[0] is t and region.exit(t * 2)[0].grad_fn.name() == "MulBackward0"
