"""Card-only tests of the PyTorch port: each hand-written kernel against its
plain torch version at the serving path's shapes, the backward kernel and the
upfirdn2d adjoint against theirs, a toy engine on the card against the same
engine on the CPU, and a toy training step's gradients on the card against
the same step on the CPU.

This file imports torch and the port only (no JAX), so it runs on a machine
that has a card but no JAX:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest -p no:cacheprovider

Without a card every test skips (the check is made inside a fixture).
"""

import contextlib
import json
import math
import os
import warnings

import numpy as np
import pytest
import torch

from viscoin_tpu_torch.models.bundle import default_models, init_models
from viscoin_tpu_torch.models.lpips import LPIPS
from viscoin_tpu_torch.ops import _kernels, bias_act, setup_filter, upfirdn2d
from viscoin_tpu_torch.ops.bias_act import _bias_act_grad_cuda, bias_act_grad_plain, bias_act_plain
from viscoin_tpu_torch.ops.upfirdn2d import upfirdn2d_plain
from viscoin_tpu_torch.serve.engine import InferenceEngine
from viscoin_tpu_torch.train import viscoin as T

pytestmark = pytest.mark.gpu
# cuBLAS is deterministic only with a fixed workspace, set before it starts
# (test_concept_extractor_backward_is_deterministic).
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

F1D = [1.0, 3.0, 3.0, 1.0]
UPFIRDN_CASES = [
    dict(up=2, down=1, padding=(3, 2, 3, 2), gain=4.0),
    dict(up=2, down=1, padding=(2, 1, 2, 1), gain=4.0),
    dict(up=1, down=2, padding=(1, 1, 1, 1), gain=1.0),
    dict(up=1, down=1, padding=2, gain=1.0),
    dict(up=1, down=1, padding=(-1, 2, 0, -2), gain=1.0),
    dict(up=1, down=1, padding=1, gain=4.0),
]
PATH_FIR = [  # the serving path's largest and smallest up-conv FIR, and a skip upsample
    ((8, 64, 257, 257), dict(up=1, down=1, padding=1, gain=4.0)),
    ((8, 512, 9, 9), dict(up=1, down=1, padding=1, gain=4.0)),
    ((8, 3, 4, 4), dict(up=2, down=1, padding=(2, 1, 2, 1), gain=4.0)),
]
RUNTIME_K = [  # tap counts other than 4 take the runtime instantiation
    ([1.0, 1.0], dict(up=2, padding=(1, 0, 1, 0))),
    ([1.0, 2.0, 1.0], dict(down=2, padding=1)),
    ([1.0, 4.0, 6.0, 4.0, 1.0], dict(up=2, padding=(2, 2, 2, 2), gain=4.0)),
    (list(range(1, 17)), dict(padding=(8, 7, 8, 7))),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_bias_act_kernel_matches_plain(cuda, dtype):
    """The synthesis layer's 256² shape and an FC's (B, F): fp32 within
    1e-6 (the same fp32 operations), bf16 within one bf16 rounding (1e-2)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    for shape in ((8, 64, 256, 256), (8, 512)):
        x = torch.randn(shape, device=cuda, generator=g).to(dtype)
        b = torch.randn(shape[1], device=cuda, generator=g)
        for kw in (dict(act="lrelu"), dict(act="linear", clamp=0.5),
                   dict(act="relu", gain=1.5), dict(act="lrelu", alpha=0.05, clamp=1.0)):
            got = bias_act(x, b, **kw)
            assert got.dtype == dtype
            torch.testing.assert_close(got.float(), bias_act_plain(x, b, **kw).float(),
                                       rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", UPFIRDN_CASES, ids=str)
def test_upfirdn2d_kernel_matches_plain(cuda, dtype, case):
    """fp32 accumulation in both; 1e-5 in fp32, 2e-2 in bf16 (the plain
    version rounds its bf16 convolution differently)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(8, 64, 67, 67, device=cuda, generator=g).to(dtype)
    f = setup_filter(F1D)
    got = upfirdn2d(x, f, **case)
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), upfirdn2d_plain(x.float(), f, **case),
                               rtol=tol, atol=tol)


def assert_fir_close(got, want, dtype):
    """fp32 within 1e-5, bf16 within 2e-2, of the output's scale."""
    assert got.dtype == dtype and got.shape == want.shape
    scale = max(1.0, float(want.float().abs().max()))
    tol = (1e-5 if dtype == torch.float32 else 2e-2) * scale
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape,case", PATH_FIR, ids=[str(s) for s, _ in PATH_FIR])
def test_upfirdn2d_kernel_at_path_shapes(cuda, dtype, shape, case):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(shape, device=cuda, generator=g).to(dtype)
    f = setup_filter(F1D)
    assert_fir_close(upfirdn2d(x, f, **case), upfirdn2d_plain(x.float(), f, **case), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", UPFIRDN_CASES, ids=str)
def test_upfirdn2d_kernel_ragged_tiles(cuda, dtype, case):
    """(3, 5, 37, 41): tiles overhang the plane on both axes."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(3, 5, 37, 41, device=cuda, generator=g).to(dtype)
    f = setup_filter(F1D)
    assert_fir_close(upfirdn2d(x, f, **case), upfirdn2d_plain(x.float(), f, **case), dtype)


def test_upfirdn2d_kernel_more_planes_than_grid_y(cuda):
    """70000 planes: more than gridDim.y could hold."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(1, 70000, 3, 3, device=cuda, generator=g)
    f = setup_filter(F1D)
    assert_fir_close(upfirdn2d(x, f, padding=1), upfirdn2d_plain(x, f, padding=1),
                     torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("taps,case", RUNTIME_K, ids=[f"k{len(t)}" for t, _ in RUNTIME_K])
def test_upfirdn2d_kernel_runtime_taps(cuda, dtype, taps, case):
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(2, 6, 23, 19, device=cuda, generator=g).to(dtype)
    f = setup_filter(taps)
    assert_fir_close(upfirdn2d(x, f, **case), upfirdn2d_plain(x.float(), f, **case), dtype)


def test_upfirdn2d_kernel_takes_a_misaligned_bf16_view(cuda):
    """A bf16 view one element into its storage: rows start mid-word, and
    the kernel stages them element by element."""
    g = torch.Generator(device=cuda).manual_seed(7)
    shape = (2, 5, 37, 41)
    base = torch.randn(math.prod(shape) + 1, device=cuda, generator=g).to(torch.bfloat16)
    x = base[1:].view(shape)
    assert x.data_ptr() % 4 != 0
    f = setup_filter(F1D)
    for case in UPFIRDN_CASES:
        assert_fir_close(upfirdn2d(x, f, **case), upfirdn2d_plain(x.float(), f, **case),
                         torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_bias_act_kernel_is_bit_equal_and_takes_misaligned_views(cuda, dtype):
    """Bit-equal to the plain version on an aligned tensor and on a view one
    element into its storage (not 16-byte aligned: the scalar variant)."""
    g = torch.Generator(device=cuda).manual_seed(6)
    shape = (8, 64, 32, 32)
    base = torch.randn(math.prod(shape) + 1, device=cuda, generator=g).to(dtype)
    b = torch.randn(shape[1], device=cuda, generator=g).to(dtype)
    for x in (base[:-1].view(shape), base[1:].view(shape)):
        for kw in (dict(act="lrelu"), dict(act="linear", clamp=0.5), dict(act="relu", gain=1.5)):
            assert torch.equal(bias_act(x, b, **kw), bias_act_plain(x, b, **kw))
    feats = base[1:8 * 512 + 1].view(8, 512)
    bf = torch.randn(513, device=cuda, generator=g).to(dtype)[1:]
    assert torch.equal(bias_act(feats, bf, act="lrelu"), bias_act_plain(feats, bf, act="lrelu"))


def test_upfirdn2d_asymmetric_taps_and_odd_channels(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 3, 10, 11, device=cuda, generator=g)
    f = setup_filter([1.0, 2.0, 4.0, 8.0])
    for flip in (False, True):
        kw = dict(up=2, padding=(3, 2, 3, 2), gain=4.0, flip_filter=flip)
        torch.testing.assert_close(upfirdn2d(x, f, **kw), upfirdn2d_plain(x, f, **kw),
                                   rtol=1e-5, atol=1e-5)


def test_toy_engine_on_the_card_matches_the_cpu(cuda):
    """A toy bundle served on the card and on the CPU from the same weights:
    logits within 1e-4, u8 reconstructions within one level; the kernels
    were launched (42-style counts scaled to the toy pyramid)."""
    cpu_models = default_models(n_classes=5, n_concepts=8, img_resolution=32,
                                channel_base=256, channel_max=16, device="cpu", seed=0)
    card = InferenceEngine(cpu_models, batch_size=4, device="cuda")
    cpu = InferenceEngine(cpu_models, batch_size=4, device="cpu")
    imgs = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    _kernels.reset_launch_counts()
    got = card.reconstruct(imgs)
    counts = _kernels.launch_counts()
    want = cpu.reconstruct(imgs)
    assert counts["bias_act"] > 0 and counts["upfirdn2d"] > 0, counts
    diff = np.abs(got["reconstruction_u8"].astype(int) - want["reconstruction_u8"].astype(int))
    assert diff.max() <= 1
    got_c, want_c = card.classify(imgs), cpu.classify(imgs)
    np.testing.assert_allclose(got_c["logits"], want_c["logits"], rtol=1e-4, atol=1e-4)


def test_toy_artifact_on_the_card_equals_the_engine_and_serves_the_cpu(cuda, tmp_path):
    """A sealed artifact traced on the card for the card and the CPU
    (serve/export.py): on the card every endpoint bit-equal to the live
    engine (cuDNN's deterministic algorithms on both: the transposed
    convolutions' atomics otherwise) with a reconstruct batch's launches
    equal; the same programs loaded on the CPU (moved there at load) equal
    to the live CPU engine. At 128², so that GradCAM's maps are not the
    constant 0 (at 32² Psi's convolutions give 1x1 maps)."""
    from viscoin_tpu_torch.serve.export import ENDPOINTS, export_serving, load_exported
    from viscoin_tpu_torch.utils.cudnn import deterministic_cudnn

    models = default_models(n_classes=5, n_concepts=8, img_resolution=128, channel_base=256,
                            channel_max=16, device="cpu", seed=1)
    manifest = export_serving(models.cuda(), str(tmp_path), batch_size=4,
                              platforms=("cuda", "cpu"))
    assert manifest["traced_on"] == "cuda:0" and manifest["platforms"] == ["cuda", "cpu"]
    imgs = np.random.default_rng(5).integers(0, 256, (5, 128, 128, 3), dtype=np.uint8)
    for device in ("cuda", "cpu"):
        artifact = load_exported(str(tmp_path), device=device)
        live = InferenceEngine(models, batch_size=4, device=device)
        with deterministic_cudnn():
            for name in ENDPOINTS:
                counts = []
                for engine in (artifact, live):
                    _kernels.reset_launch_counts()
                    out = getattr(engine, name)(imgs)
                    counts.append(_kernels.launch_counts())
                    if engine is artifact:
                        got = out
                for key in out:
                    assert np.array_equal(got[key], out[key]), (device, name, key)
                assert counts[0] == counts[1], (device, name, counts)
                if device == "cuda" and name == "reconstruct":
                    assert counts[0]["bias_act"] > 0 and counts[0]["upfirdn2d"] > 0, counts
                if name == "explain":
                    maps = [out[f"heatmap_conv{i}"] for i in range(1, 6)]
                    assert any((m.max(axis=(1, 2)) > m.min(axis=(1, 2))).any() for m in maps)


GRAD_KW = (dict(act="lrelu", alpha=None, gain=2.0 ** 0.5, clamp=None),
           dict(act="linear", alpha=None, gain=1.0, clamp=0.5),
           dict(act="relu", alpha=None, gain=1.5, clamp=None),
           dict(act="lrelu", alpha=0.05, gain=1.0, clamp=1.0))


def assert_db_close(got, want):
    """db sums with fp32 atomics in another order than the plain version:
    within 1e-5 of its scale, plus one rounding to the bias's type (two fp32
    sums on either side of a bf16 rounding boundary round one unit apart)."""
    assert got.dtype == want.dtype and got.device == want.device
    scale = max(1.0, float(want.float().abs().max()))
    slack = 1e-5 * scale + torch.finfo(want.dtype).eps * want.float().abs()
    assert bool(((got.float() - want.float()).abs() <= slack).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_bias_act_grad_kernel_matches_plain(cuda, dtype):
    """Both row modes ((n, c) planes, (B, F) features) and a small plane,
    aligned and misaligned (one element into storage) views, with and
    without a bias: dx bit-equal to the plain version, db within 1e-5 of its
    scale; inputs on a 1/8 grid so that the ties occur."""
    g = torch.Generator(device=cuda).manual_seed(8)
    for shape in ((8, 64, 32, 32), (8, 512), (8, 512, 4, 4), (3, 5, 7, 3)):
        n = math.prod(shape)
        base = (torch.randint(-24, 25, (n + 1,), device=cuda, generator=g) / 8).to(dtype)
        dy = torch.randn(shape, device=cuda, generator=g).to(dtype)
        b = (torch.randint(-8, 9, (shape[1] + 1,), device=cuda, generator=g) / 8).to(dtype)
        for x, bias in ((base[:-1].view(shape), b[:-1]), (base[1:].view(shape), b[1:]),
                        (base[:-1].view(shape), None)):
            for kw in GRAD_KW:
                dx, db = _bias_act_grad_cuda(x, bias, dy, None, **kw)
                want_dx, want_db = bias_act_grad_plain(x, bias, dy, **kw)
                assert dx.dtype == dtype and torch.equal(dx, want_dx), (shape, kw)
                if bias is None:
                    assert db is None
                else:
                    assert_db_close(db, want_db)


def test_bias_act_grad_kernel_takes_expanded_dy_and_counts(cuda):
    """Through autograd: the gradient of a mean is a stride-0 tensor; an fp32
    bias on a bf16 input gets an fp32 db; each backward is one launch of
    bias_act_grad, and the output of the forward has a grad_fn."""
    g = torch.Generator(device=cuda).manual_seed(9)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(8, 64, 16, 16, device=cuda, generator=g).to(dtype).requires_grad_()
        b = torch.randn(64, device=cuda, generator=g).requires_grad_()
        _kernels.reset_launch_counts()
        y = bias_act(x, b, act="lrelu", clamp=2.0)
        assert y.grad_fn is not None
        y.mean().backward()
        counts = _kernels.launch_counts()
        assert counts["bias_act"] == 1 and counts["bias_act_grad"] == 1, counts
        dy = torch.full(x.shape, 1.0 / x.numel(), device=cuda).to(dtype)
        want_dx, want_db = bias_act_grad_plain(x.detach(), b.detach(), dy, act="lrelu",
                                               gain=2.0 ** 0.5, clamp=2.0)
        assert torch.equal(x.grad, want_dx)
        assert_db_close(b.grad, want_db)
        # A second order needs dy to require grad (here dy = 2 y): the
        # backward kernel once as the second order of the first backward
        # (with dy_add where db is used), and once as the first order of the
        # forward, through dy = 2 y; a third order raises.
        (gx,) = torch.autograd.grad(bias_act(x, b, act="lrelu").square().sum(), x,
                                    create_graph=True)
        _kernels.reset_launch_counts()
        (gg,) = torch.autograd.grad(gx.square().sum(), x, create_graph=True)
        assert _kernels.launch_counts()["bias_act_grad"] == 2
        with pytest.raises(RuntimeError, match="once_differentiable"):
            gg.sum().backward()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_bias_act_grad_kernel_with_dy_add_matches_plain(cuda, dtype):
    """The second-order mode: the per-channel fp32 dy_add (g_db) added to dy
    in the pass, without db, in both row modes, aligned and misaligned:
    bit-equal to the plain version."""
    g = torch.Generator(device=cuda).manual_seed(12)
    for shape in ((8, 64, 32, 32), (8, 512), (16, 512, 4, 4), (3, 5, 7, 3)):
        n = math.prod(shape)
        base = (torch.randint(-24, 25, (n + 1,), device=cuda, generator=g) / 8).to(dtype)
        dy = torch.randn(shape, device=cuda, generator=g).to(dtype)
        b = (torch.randint(-8, 9, (shape[1],), device=cuda, generator=g) / 8).to(dtype)
        add = torch.randn(shape[1], device=cuda, generator=g)
        for x in (base[:-1].view(shape), base[1:].view(shape)):
            for kw in GRAD_KW:
                dx, db = _bias_act_grad_cuda(x, b, dy, dy_add=add, need_db=False, **kw)
                want, _ = bias_act_grad_plain(x, b, dy, dy_add=add, need_db=False, **kw)
                assert db is None and torch.equal(dx, want), (shape, kw)


def test_bias_act_grad_db_is_deterministic(cuda):
    """db has no atomics: a fixed-order sum of per-(row, chunk) partials, so
    repeated calls give the same bits (planes of several chunks, small
    planes and (B, F) features), within 1e-5 of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(15)
    for shape in ((16, 64, 256, 256), (16, 512, 4, 4), (16, 512)):
        x = torch.randn(shape, device=cuda, generator=g)
        dy = torch.randn(shape, device=cuda, generator=g)
        b = torch.randn(shape[1], device=cuda, generator=g)
        kw = GRAD_KW[0]
        dbs = [_bias_act_grad_cuda(x, b, dy, None, **kw)[1] for _ in range(5)]
        assert all(torch.equal(dbs[0], d) for d in dbs[1:]), shape
        assert_db_close(dbs[0], bias_act_grad_plain(x, b, dy, **kw)[1])


def test_r1_penalty_through_both_kernels_on_the_card_matches_the_cpu(cuda):
    """An R1-shaped second order through a discriminator block (fromrgb,
    the FIR-then-stride-2 convs, lrelu with a clamp): the gradients of
    sum((d sum(D(x)) / dx)^2) for every parameter, card against CPU in fp32,
    within 1e-3 of each leaf's max |grad|; the second order launched
    bias_act_grad and upfirdn2d on the card."""
    from viscoin_tpu_torch.models.stylegan import DiscriminatorBlock

    x = torch.from_numpy(np.random.default_rng(13).uniform(-1, 1, (4, 3, 32, 32))
                         .astype(np.float32))
    out = {}
    for device in ("cpu", "cuda"):
        block = init_models(DiscriminatorBlock(0, 16, 32, conv_clamp=0.5, device="cpu"), 3)
        block = block.to(device)
        xd = x.to(device).requires_grad_()
        (gx,) = torch.autograd.grad(block(None, xd).sum(), xd, create_graph=True)
        _kernels.reset_launch_counts()
        grads = torch.autograd.grad(gx.square().sum(), list(block.parameters()),
                                    materialize_grads=True)
        out[device] = ([t.cpu() for t in grads], _kernels.launch_counts())
    (g_cpu, c_cpu), (g_gpu, c_gpu) = out["cpu"], out["cuda"]
    assert set(c_cpu.values()) == {0} and c_gpu["bias_act_grad"] > 0 and c_gpu["upfirdn2d"] > 0
    for want, got in zip(g_cpu, g_gpu):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-3 * max(scale, 1e-12)


def test_toy_gan_step_on_the_card_matches_the_cpu(cuda):
    """One GAN step at step 0 (R1 and path length on) at toy widths, on the
    card and on the CPU from the same weights and draws (noise strengths
    zero): the losses within 1e-4, R1 and the path lengths within 1e-3,
    both Adams' first moments (the gradients) within 1e-2 of each leaf's
    max |grad|, but for the noise strengths, whose gradient projects onto
    each device's own random noise (finite there); every kernel launched on
    the card. The learning rate is 0 so that both D phases run the same
    generator (Adam's first update turns the last bits of a gradient near
    zero into a step of lr)."""
    from viscoin_tpu_torch.models.stylegan import Discriminator, Generator
    from viscoin_tpu_torch.train import gan as TG

    cfg = TG.GANTrainingParams(batch_size=4, augment_p=0.3, learning_rate=0.0)
    images = torch.from_numpy(np.random.default_rng(14).integers(0, 256, (4, 32, 32, 3),
                                                                  dtype=np.uint8))
    out = {}
    for device in ("cpu", "cuda"):
        g = init_models(Generator(z_dim=16, w_dim=32, img_resolution=32, channel_base=256,
                                  channel_max=16, mapping_layers=2, device="cpu"), 4)
        d = init_models(Discriminator(img_resolution=32, channel_base=256, channel_max=16,
                                      mbstd_group_size=4, device="cpu"), 5)
        g, d = g.to(device), d.to(device)
        state = TG.create_gan_train_state(g, d, cfg)
        draws = TG.draw_step(cfg, g, 0, 0, "cpu").to(device)
        _kernels.reset_launch_counts()
        _, m = TG.make_gan_train_step(g, d, cfg)(state, images.to(device), draws)
        moments = [state.g_opt.state[p]["exp_avg"].cpu()
                   for n, p in g.named_parameters() if not n.endswith("noise_strength")] + [
            state.d_opt.state[p]["exp_avg"].cpu() for p in d.parameters()]
        assert all(bool(torch.isfinite(state.g_opt.state[p]["exp_avg"]).all())
                   for p in g.parameters())
        out[device] = ({k: float(v) for k, v in m.items()}, moments, _kernels.launch_counts())
    (m_cpu, g_cpu, c_cpu), (m_gpu, g_gpu, c_gpu) = out["cpu"], out["cuda"]
    assert set(c_cpu.values()) == {0} and min(c_gpu.values()) > 0, c_gpu
    for k in ("g_loss", "d_loss"):
        assert abs(m_gpu[k] - m_cpu[k]) <= 1e-4 * abs(m_cpu[k]), k
    for k in ("r1", "pl_lengths"):
        assert m_cpu[k] > 0 and abs(m_gpu[k] - m_cpu[k]) <= 1e-3 * m_cpu[k], k
    for want, got in zip(g_cpu, g_gpu):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-2 * max(scale, 1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape,case", PATH_FIR, ids=[str(s) for s, _ in PATH_FIR])
def test_upfirdn2d_adjoint_on_the_card(cuda, dtype, shape, case):
    """The backward of each path FIR is one more launch of the kernel (the
    adjoint); it matches the CPU's adjoint (fp32 1e-5, bf16 2e-2 of the
    scale) and <y, A x> = <A^T y, x> holds in fp32."""
    g = torch.Generator(device=cuda).manual_seed(10)
    f = setup_filter(F1D)
    x = torch.randn(shape, device=cuda, generator=g).to(dtype).requires_grad_()
    _kernels.reset_launch_counts()
    y = upfirdn2d(x, f, **case)
    assert y.grad_fn is not None
    dy = torch.randn(y.shape, device=cuda, generator=g).to(dtype)
    y.backward(dy)
    assert _kernels.launch_counts()["upfirdn2d"] == 2
    xc = x.detach().float().cpu().requires_grad_()
    upfirdn2d(xc, f, **case).backward(dy.float().cpu())
    assert_fir_close(x.grad, xc.grad.to(dtype).to(cuda) if dtype == torch.bfloat16
                     else xc.grad.to(cuda), dtype)
    if dtype == torch.float32:
        lhs = float((y.detach().double() * dy.double()).sum())
        rhs = float((x.detach().double() * x.grad.double()).sum())
        assert abs(lhs - rhs) <= 1e-5 * max(1.0, abs(lhs))


def _toy_training(device):
    models = default_models(n_classes=4, n_concepts=8, img_resolution=64, channel_base=256,
                            channel_max=16, device="cpu", seed=0)
    with torch.no_grad():  # non-zero biases, so every bias path is exercised
        for name, p in models.named_parameters():
            if name.endswith("bias"):
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    lpips = init_models(LPIPS(device="cpu"), seed=2)
    models, lpips = models.to(device), lpips.to(device)
    cfg = T.VisCoINTrainingParams(batch_size=2, cd_fid_iteration=-1)
    frozen = T.make_frozen(models, None, lpips)
    state = T.create_train_state(models, cfg)
    return models, cfg, frozen, state


def test_toy_train_step_gradients_on_the_card_match_the_cpu(cuda):
    """One fp32 loss on the card and on the CPU from the same weights, inputs
    and dropout mask (noise strengths are zero at init): the totals within
    1e-4 and every trainable gradient within 1e-3 of its leaf's max |grad|;
    all three kernels launched, and every leaf has a non-zero gradient."""
    rng = np.random.default_rng(0)
    real = torch.from_numpy(rng.standard_normal((2, 3, 64, 64)).astype(np.float32))
    fake = torch.from_numpy(rng.standard_normal((2, 3, 64, 64)).astype(np.float32))
    labels = torch.tensor([1, 3])
    mask = torch.from_numpy(rng.random((4, 8, 3, 3)) < 0.99)
    out = {}
    for device in ("cpu", "cuda"):
        models, cfg, frozen, state = _toy_training(device)
        loss_fn = T.make_loss_fn(models, None, None, cfg)
        _kernels.reset_launch_counts()
        total, _ = loss_fn(state.params, frozen, real.to(device), labels.to(device), 0,
                           torch.Generator(device=device).manual_seed(0), fake.to(device),
                           dropout_mask=mask.to(device))
        total.backward()
        counts = _kernels.launch_counts()
        out[device] = (float(total), {(g, n): p.grad.cpu() for g, grp in state.params.items()
                                      for n, p in grp.items()}, counts)
    (t_cpu, g_cpu, c_cpu), (t_gpu, g_gpu, c_gpu) = out["cpu"], out["cuda"]
    assert set(c_cpu.values()) == {0}
    assert min(c_gpu.values()) > 0, c_gpu
    assert abs(t_gpu - t_cpu) <= 1e-4 * abs(t_cpu)
    for key, want in g_cpu.items():
        scale = float(want.abs().max())
        assert scale > 0 and float(g_gpu[key].abs().max()) > 0, key
        assert float((g_gpu[key] - want).abs().max()) <= 1e-3 * scale, key


def _toy_loop_modules(device):
    from viscoin_tpu_torch.models.stylegan import Generator

    models = default_models(n_classes=4, n_concepts=8, img_resolution=32, channel_base=256,
                            channel_max=16, device=device, seed=0)
    gen = init_models(Generator(z_dim=16, w_dim=32, img_resolution=32, channel_base=256,
                                channel_max=16, mapping_layers=2, device=device), 1)
    return models, gen, init_models(LPIPS(device=device), 2)


def test_toy_loop_on_the_card_resumes_and_counts(cuda, tmp_path):
    """train_viscoin on the card (pinned batches, prefetch 1, the native
    loader): 4 steps, eval and checkpoint every 2; then 2 + a resume to 4
    takes the same batches and seeds and ends within 1e-3 of the unbroken
    run's losses; the kernels were launched, forward and backward."""
    from viscoin_tpu_torch.data.datasets import SyntheticDataset
    from viscoin_tpu_torch.data.loader import DataLoader
    from viscoin_tpu_torch.utils.logging import configure_score_logging

    def run(directory, **kw):
        models, gen, lpips = _toy_loop_modules(cuda)
        tl = DataLoader(SyntheticDataset(n=6, n_classes=4, image_size=32), 2, seed=1)
        el = DataLoader(SyntheticDataset(n=3, n_classes=4, image_size=32, mode="test"), 2,
                        shuffle=False)
        configure_score_logging(str(tmp_path / f"{directory}.jsonl"))
        losses = []
        orig = T.make_train_step

        def make(*a, **k):
            step = orig(*a, **k)

            def wrapped(state, *args):
                state, metrics = step(state, *args)
                losses.append(float(metrics["total_loss"]))
                return state, metrics

            return wrapped

        T.make_train_step = make
        try:
            T.train_viscoin(models, gen, lpips, tl, el, T.VisCoINTrainingParams(
                iterations=4, batch_size=2, cd_fid_iteration=-1), checkpoint_dir=str(
                tmp_path / directory), eval_every=2, checkpoint_every=2, faithfulness_every=2,
                prefetch=1, **kw)
        finally:
            T.make_train_step = orig
        return losses

    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    _kernels.reset_launch_counts()
    unbroken = run("a")
    counts = _kernels.launch_counts()
    assert min(counts.values()) > 0, counts
    first = run("b", stop_after=3)
    rest = run("b", resume_from=str(tmp_path / "b" / "train_state"))
    assert len(first) == 3 and len(rest) == 1
    np.testing.assert_allclose(first + rest, unbroken, rtol=1e-3)
    with open(tmp_path / "a.jsonl") as f:
        assert len(f.readlines()) == 2


@contextlib.contextmanager
def _deterministic():
    """cuDNN's deterministic algorithms and torch's (warn_only), the
    defaults after: two runs of one step are then equal bit for bit."""
    from viscoin_tpu_torch.utils.cudnn import deterministic_cudnn

    with deterministic_cudnn(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)


def _forced_eager(monkeypatch):
    """Every VisCoIN step eager, as on a host without a card."""
    monkeypatch.setattr(T, "eager_reason", lambda *a, **k: "forced")


@pytest.mark.parametrize("accumulation,data_parallel", [(1, False), (2, False), (1, True)],
                         ids=["plain", "accumulation_2", "nccl_world_1"])
def test_graphed_viscoin_step_is_bit_equal_to_the_eager_step(cuda, monkeypatch, accumulation,
                                                             data_parallel):
    """Six steps of the toy bundle (32², batch 2, synthetic batches two
    steps at a time) as CUDA graph replays and eagerly, under deterministic
    algorithms: steps 0-5 cross the cd_fid_iteration gate (2: the second
    capture is at step 3) and two sampler groups' boundaries, with gradient
    accumulation 2 three update windows, and on a data-parallel mesh (NCCL
    at world size 1, as `torchrun --nproc-per-node 1` runs the trainer) the
    gradient all-reduce and the metrics' mean after each replay. Every
    metric (kept as returned, so an alias between two calls' metrics would
    show), every gradient or accumulated mean after each step, every
    parameter and both Adams' moments are bit-equal; the counter reads two
    captures, six replays (the capturing steps replay too) and no eager
    step. The kernels' launch counts count what the card ran: the warm-up
    and each replay, not the capture."""
    from torch_dp_worker import free_port

    from viscoin_tpu_torch.parallel import mesh as M
    from viscoin_tpu_torch.utils import tracing

    mesh = None
    if data_parallel:
        for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                         MASTER_PORT=str(free_port())).items():
            monkeypatch.setenv(k, v)
        mesh = M.make_mesh("cuda")

    def run():
        models, gen, lpips = _toy_loop_modules(cuda)
        cfg = T.VisCoINTrainingParams(iterations=10, batch_size=2, cd_fid_iteration=2,
                                      gradient_accumulation=accumulation,
                                      fake_presample_steps=2)
        frozen = T.make_frozen(models, gen, lpips)
        state = T.create_train_state(models, cfg)
        step = T.make_train_step(models, gen, lpips, cfg, external_fakes=True, mesh=mesh)
        sample = T.make_sample_fakes(gen, cfg, mesh)
        g = torch.Generator(device=cuda).manual_seed(3)
        images = torch.randint(0, 256, (12, 32, 32, 3), generator=g, device=cuda,
                               dtype=torch.uint8)
        labels = torch.randint(0, 4, (12,), generator=g, device=cuda)
        steps, launches = [], []
        for i in range(6):
            if i % 2 == 0:
                fakes = sample(frozen, T.fake_sample_keys(7, i, 2))
            _kernels.reset_launch_counts()
            rng = T.step_generator(7, i, cuda, mesh)
            _, metrics = step(state, frozen, images[2 * i: 2 * i + 2], labels[2 * i: 2 * i + 2],
                              rng, fakes[i % 2])
            launches.append(sum(_kernels.launch_counts().values()))
            grads = ({f"{g}.{n}": p.grad.clone() for g, grp in state.params.items()
                      for n, p in grp.items() if p.grad is not None} if accumulation == 1
                     else {f"{g}.{n}": a.clone() for g, grp in state.acc.items()
                           for n, a in grp.items()})
            steps.append((metrics, grads, rng.get_state()))
        tensors = {f"{g}.{n}": p.detach().clone() for g, grp in state.params.items()
                   for n, p in grp.items()}
        for opt in (state.opt, state.gan_opt):
            for k, p in enumerate(p for group in opt.param_groups for p in group["params"]):
                tensors.update({f"{id(opt)}.{k}.{name}": v for name, v in opt.state[p].items()
                                if name != "step"})
        return steps, list(tensors.values()), launches

    try:
        with _deterministic():
            tracing.reset_graph_counts()
            M.reset_collective_counts()
            graphed, graphed_tensors, launches = run()
            counts, collectives = tracing.graph_counts(), M.collective_counts()
            with monkeypatch.context() as m:
                _forced_eager(m)
                eager, eager_tensors, eager_launches = run()
    finally:
        if mesh is not None:
            M.destroy_mesh(mesh)
    assert counts == {"captures": 2, "replays": 6}, counts
    if data_parallel:  # one all-reduce per update (one dtype) and one mean a step
        assert (collectives["grad"], collectives["mean"]) == (6, 6), collectives
    passes = [1 + T.GRAPH_WARMUP if i in (0, 3) else 1 for i in range(6)]  # 0, 3: captures
    assert min(eager_launches) > 0, eager_launches
    assert launches == [n * e for n, e in zip(passes, eager_launches)], (launches, eager_launches)
    assert len(graphed_tensors) == len(eager_tensors)
    for a, b in zip(graphed_tensors, eager_tensors):
        assert torch.equal(a, b)
    for i, ((m_g, g_g, s_g), (m_e, g_e, s_e)) in enumerate(zip(graphed, eager)):
        assert torch.equal(s_g, s_e), i  # the step's generator advanced alike
        assert m_g.keys() == m_e.keys() and g_g.keys() == g_e.keys(), i
        for k in m_e:
            assert torch.equal(m_g[k], m_e[k]), (i, k)
        for k in g_e:
            assert torch.equal(g_g[k], g_e[k]), (i, k)


def test_graphed_step_captures_again_when_a_kernel_setting_changes(cuda, monkeypatch):
    """Three steps of the toy bundle with cuDNN's TF32 off, on, then off
    again: each change captures anew (three captures, three replays, the
    graph of the setting before dropped), and every step is bit-equal to
    the eager step under the same setting."""
    from viscoin_tpu_torch.utils import tracing

    def run():
        models, gen, lpips = _toy_loop_modules(cuda)
        cfg = T.VisCoINTrainingParams(iterations=10, batch_size=2, cd_fid_iteration=-1)
        frozen = T.make_frozen(models, gen, lpips)
        state = T.create_train_state(models, cfg)
        step = T.make_train_step(models, gen, lpips, cfg, external_fakes=True)
        g = torch.Generator(device=cuda).manual_seed(3)
        images = torch.randint(0, 256, (2, 32, 32, 3), generator=g, device=cuda,
                               dtype=torch.uint8)
        labels = torch.randint(0, 4, (2,), generator=g, device=cuda)
        fake = torch.randn((2, 3, 32, 32), generator=g, device=cuda)
        metrics = []
        try:
            for i, tf32 in enumerate((False, True, False)):
                torch.backends.cudnn.allow_tf32 = tf32
                metrics.append(step(state, frozen, images, labels, T.step_generator(7, i, cuda),
                                    fake)[1])
        finally:
            torch.backends.cudnn.allow_tf32 = False
        return metrics, [p.detach().clone() for grp in state.params.values()
                         for p in grp.values()]

    with _deterministic():
        tracing.reset_graph_counts()
        graphed = run()
        counts = tracing.graph_counts()
        with monkeypatch.context() as m:
            _forced_eager(m)
            eager = run()
    assert counts == {"captures": 3, "replays": 3}, counts
    for a, b in zip(graphed[0], eager[0]):
        assert all(torch.equal(a[k], b[k]) for k in b)
    assert all(torch.equal(a, b) for a, b in zip(graphed[1], eager[1]))


def test_toy_loop_with_graphed_steps_logs_what_the_eager_loop_logs(cuda, tmp_path, monkeypatch):
    """train_viscoin on the card for 4 steps with an eval every 2 (and the
    probe and a checkpoint between steps), graphed and eagerly, under
    deterministic algorithms: the jsonl records are equal, so the eval read
    the parameters the replays trained."""
    from viscoin_tpu_torch.data.datasets import SyntheticDataset
    from viscoin_tpu_torch.data.loader import DataLoader
    from viscoin_tpu_torch.utils import tracing
    from viscoin_tpu_torch.utils.logging import configure_score_logging

    def run(name):
        models, gen, lpips = _toy_loop_modules(cuda)
        tl = DataLoader(SyntheticDataset(n=6, n_classes=4, image_size=32), 2, seed=1)
        el = DataLoader(SyntheticDataset(n=3, n_classes=4, image_size=32, mode="test"), 2,
                        shuffle=False)
        (tmp_path / name).mkdir()
        configure_score_logging(str(tmp_path / f"{name}.jsonl"))
        T.train_viscoin(models, gen, lpips, tl, el, T.VisCoINTrainingParams(
            iterations=4, batch_size=2, cd_fid_iteration=-1), checkpoint_dir=str(tmp_path / name),
            eval_every=2, checkpoint_every=2, faithfulness_every=2, prefetch=1)
        with open(tmp_path / f"{name}.jsonl") as f:
            return [json.loads(line) for line in f]

    with _deterministic():
        tracing.reset_graph_counts()
        graphed = run("graphed")
        assert tracing.graph_counts() == {"captures": 1, "replays": 4}
        with monkeypatch.context() as m:
            _forced_eager(m)
            eager = run("eager")
    assert len(graphed) == 2 and graphed == eager


def test_toy_amplify_on_the_card_matches_the_cpu(cuda):
    models, _, _ = _toy_loop_modules("cpu")
    card = InferenceEngine(models, batch_size=2, device="cuda")
    cpu = InferenceEngine(models, batch_size=2, device="cpu")
    img = np.random.default_rng(1).integers(0, 256, (40, 40, 3), dtype=np.uint8)
    _kernels.reset_launch_counts()
    got = card.amplify(img, {"method": "top_k", "k": 3}, [0.0, 1.0, 2.0], seed=3)
    assert _kernels.launch_counts()["upfirdn2d"] > 0
    want = cpu.amplify(img, {"method": "top_k", "k": 3}, [0.0, 1.0, 2.0], seed=3)
    np.testing.assert_allclose(got.best_concept_probas_best, want.best_concept_probas_best,
                               atol=1e-4)
    for g, w in zip(got.amplified_images, want.amplified_images):
        np.testing.assert_allclose(g, w, atol=1e-3)


def _explain_engines(dtype: str = "float32"):
    """A bundle with ResNet-50 and Psi at their full widths at 128² (Psi's
    conv outputs 4x4), on the card and on the CPU from the same weights."""
    models = default_models(n_classes=10, n_concepts=64, img_resolution=128, channel_base=1024,
                            channel_max=64, device="cpu", seed=2)
    return (InferenceEngine(models, batch_size=4, compute_dtype=dtype, device="cuda"),
            InferenceEngine(models, batch_size=4, compute_dtype=dtype, device="cpu"))


def test_explain_on_the_card_is_deterministic_and_padding_invariant(cuda):
    """explain launches no kernel of the port; two calls on one batch are
    bit-equal (the backward runs under cuDNN's deterministic algorithms);
    a row alone equals the same row in a padded batch."""
    card, _ = _explain_engines()
    imgs = np.random.default_rng(3).integers(0, 256, (5, 128, 128, 3), dtype=np.uint8)
    _kernels.reset_launch_counts()
    first = card.explain(imgs)
    assert set(_kernels.launch_counts().values()) == {0}
    second = card.explain(imgs)
    for key in first:
        assert np.array_equal(first[key], second[key]), key
    assert first["heatmap_conv1"].shape == (5, 4, 4)
    for i in range(3):
        alone = card.explain(imgs[i])
        for k in range(1, 6):
            np.testing.assert_allclose(alone[f"heatmap_conv{k}"][0],
                                       first[f"heatmap_conv{k}"][i], rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_explain_on_the_card_matches_the_cpu(cuda, dtype):
    """The same weights on the card (TF32 off) and on the CPU: fp32 heatmaps
    within 1e-3 (they lie in [0, 1]) and the same predictions; bf16 maps
    finite in [0, 1]."""
    card, cpu = _explain_engines(dtype)
    imgs = np.random.default_rng(4).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = card.explain(imgs)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    for k in range(1, 6):
        hm = got[f"heatmap_conv{k}"]
        assert hm.dtype == np.float32 and np.isfinite(hm).all()
        assert hm.min() >= 0 and hm.max() <= 1
    if dtype == "float32":
        want = cpu.explain(imgs)
        np.testing.assert_array_equal(got["expl_preds"], want["expl_preds"])
        for k in range(1, 6):
            np.testing.assert_allclose(got[f"heatmap_conv{k}"], want[f"heatmap_conv{k}"],
                                       rtol=0, atol=1e-3)


def test_concept_extractor_backward_is_deterministic(cuda):
    """The flagship concept extractor's backward at 256² shapes runs under
    torch.use_deterministic_algorithms(True) (no op on it lacks a
    deterministic version: the 3x3 pooling is two matrix products) and gives
    bit-equal gradients twice."""
    from viscoin_tpu_torch.models.concept_extractor import ConceptExtractor

    psi = init_models(ConceptExtractor(device="cuda"), 0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    latents = [torch.randn(s, device="cuda", generator=gen).relu()
               for s in ((4, 512, 32, 32), (4, 1024, 16, 16), (4, 2048, 8, 8))]
    params = list(psi.parameters())

    def grads():
        phi, phi_prime = psi(latents)
        loss = phi.square().mean() + phi_prime.square().mean()
        return torch.autograd.grad(loss, params)

    torch.use_deterministic_algorithms(True)
    try:
        first, second = grads(), grads()
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert any(float(g.abs().max()) > 0 for g in first)


def test_inception_on_the_card_matches_the_cpu(cuda):
    """The FID detector's Inception (cuDNN convolutions, TF32 off) at 299²,
    batch 2, the same random weights: features within 1e-4 of their scale."""
    from viscoin_tpu_torch.models.inception import InceptionV3Features

    assert torch.backends.cudnn.is_available() and torch.backends.cudnn.enabled
    torch.manual_seed(0)
    cpu = InceptionV3Features(device="cpu").eval()
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    card = InceptionV3Features(device="cuda").eval()
    card.load_state_dict(cpu.state_dict())
    x = torch.rand(2, 3, 299, 299) * 2 - 1
    with torch.no_grad():
        want = cpu(x)
        got = card(x.cuda()).cpu()
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-4 * float(want.abs().max()))


def test_fid_sampling_launches_match_the_cpu(cuda):
    """`train gan --fid-every`'s sampling of the EMA generator (under
    no_grad, random noise): the kernels it launches on the card, counted by
    the wrappers, equal the plain-version calls of the same sampling on the
    CPU."""
    import importlib

    from viscoin_tpu_torch.models.stylegan import Generator
    from viscoin_tpu_torch.train.gan import make_gan_fid_fns

    ba = importlib.import_module("viscoin_tpu_torch.ops.bias_act")
    up = importlib.import_module("viscoin_tpu_torch.ops.upfirdn2d")

    kw = dict(z_dim=8, w_dim=16, img_resolution=32, channel_base=256, channel_max=16,
              mapping_layers=2)
    fake, _ = make_gan_fid_fns(4)
    counts = {"bias_act": 0, "upfirdn2d": 0}
    orig = ba.bias_act_plain, up.upfirdn2d_plain

    def counted(name, f):
        def wrapped(*a, **k):
            counts[name] += 1
            return f(*a, **k)
        return wrapped

    ba.bias_act_plain, up.upfirdn2d_plain = counted("bias_act", orig[0]), counted("upfirdn2d",
                                                                                  orig[1])
    try:
        fake(init_models(Generator(**kw, device="cpu"), 1).eval(), 5)
    finally:
        ba.bias_act_plain, up.upfirdn2d_plain = orig
    g = init_models(Generator(**kw, device="cuda"), 1).eval()
    _kernels.reset_launch_counts()
    fake(g, 5)
    torch.cuda.synchronize()
    got = _kernels.launch_counts()
    assert {k: got[k] for k in counts} == counts and got["bias_act_grad"] == 0
    assert min(counts.values()) > 0


def test_projection_step_gradients_on_the_card_match_the_cpu(cuda):
    """One projection step's loss and gradients (w and every noise buffer,
    the noise penalty on) through a frozen toy generator and LPIPS: the card
    against the CPU within 1e-3 of each leaf's largest gradient, TF32 off.
    On the card the backward launches bias_act_grad without the bias
    gradient (need_db False on every call: the parameters are frozen) and
    the upfirdn2d adjoint at batch 1."""
    import importlib

    from viscoin_tpu_torch.eval.projection import projection_loss
    from viscoin_tpu_torch.models.stylegan import Generator

    ba = importlib.import_module("viscoin_tpu_torch.ops.bias_act")
    up = importlib.import_module("viscoin_tpu_torch.ops.upfirdn2d")
    kw = dict(z_dim=8, w_dim=16, img_resolution=32, channel_base=256, channel_max=16,
              mapping_layers=2)
    g = init_models(Generator(**kw, device="cpu"), 3)
    with torch.no_grad():  # live noise: the buffers' gradients are not zero
        for name, p in g.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.3)
    g.eval().requires_grad_(False)
    lp = init_models(LPIPS(device="cpu"), 4).eval().requires_grad_(False)
    gen = torch.Generator().manual_seed(5)
    w = g.mapping(torch.randn(1, 8, generator=gen))[:, 0]
    noise = {k: torch.randn(b.shape, generator=gen) for k, b in g.synthesis.named_buffers()
             if k.endswith("noise_const")}
    target = torch.rand(1, 3, 32, 32, generator=gen) * 2 - 1

    def step(device):
        leaves = {k: v.to(device).requires_grad_() for k, v in noise.items()}
        wd = w.to(device).requires_grad_()
        loss, dist = projection_loss(g.to(device), lp.to(device), wd, leaves,
                                     target.to(device))
        grads = torch.autograd.grad(loss, [wd, *leaves.values()])
        return [loss, dist, *grads]

    want = step("cpu")
    calls = []
    orig_grad, orig_up = ba._bias_act_grad_cuda, up._upfirdn2d_cuda

    def rec_grad(x, b, dy, *, need_db=True, **k):
        calls.append(("bias_act_grad", need_db and b is not None))
        return orig_grad(x, b, dy, need_db=need_db, **k)

    def rec_up(x, f, **k):
        calls.append(("upfirdn2d", x.shape[0]))
        return orig_up(x, f, **k)

    ba._bias_act_grad_cuda, up._upfirdn2d_cuda = rec_grad, rec_up
    try:
        _kernels.reset_launch_counts()
        got = step(cuda)
        torch.cuda.synchronize()
    finally:
        ba._bias_act_grad_cuda, up._upfirdn2d_cuda = orig_grad, orig_up
    counts = _kernels.launch_counts()
    assert counts["bias_act_grad"] > 0 and counts["upfirdn2d"] > 0 and counts["bias_act"] > 0
    assert not any(db for op, db in calls if op == "bias_act_grad")
    assert {n for op, n in calls if op == "upfirdn2d"} == {1}
    for a, b in zip(got, want):
        scale = b.abs().max().clamp_min(1e-30)
        assert float((a.cpu() - b).abs().max() / scale) <= 1e-3


def test_collectives_at_world_1_over_nccl(cuda, monkeypatch):
    """parallel/mesh.py's collectives through NCCL at world size 1, as
    `torchrun --nproc-per-node 1` runs the trainers: all_gather_batch and
    all_mean are the identity in value, first and second derivative;
    all_reduce_grads returns its input's values, broadcast_tree and the
    barrier run."""
    from torch_dp_worker import free_port

    from viscoin_tpu_torch.parallel import mesh as M

    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(free_port())).items():
        monkeypatch.setenv(k, v)
    mesh = M.make_mesh("cuda")
    try:
        assert torch.distributed.get_backend() == "nccl" and mesh.device == torch.device("cuda", 0)
        g = torch.Generator(device=cuda).manual_seed(0)
        x = torch.randn(4, 3, device=cuda, generator=g, requires_grad=True)

        def derivatives(gather, mean):
            loss = (gather(x) ** 3).sum() + (mean(x.mean(0)) ** 2).sum()
            (d1,) = torch.autograd.grad(loss, x, create_graph=True)
            (d2,) = torch.autograd.grad((d1 ** 2).sum(), x)
            return loss, d1, d2

        got = derivatives(lambda t: M.all_gather_batch(t, mesh), lambda t: M.all_mean(t, mesh))
        for a, b in zip(got, derivatives(lambda t: t, lambda t: t)):
            assert torch.equal(a, b)
        grads = [torch.randn(5, device=cuda, generator=g), torch.randn(2, 2, device=cuda,
                                                                       generator=g)]
        for a, b in zip(M.all_reduce_grads(grads, mesh), grads):
            assert torch.equal(a, b)
        before = [t.clone() for t in grads]
        M.broadcast_tree(grads, mesh)
        M.barrier(mesh)
        assert all(torch.equal(a, b) for a, b in zip(grads, before))
    finally:
        M.destroy_mesh(mesh)


def test_two_process_gloo_steps_on_the_card(cuda, tmp_path):
    """Two processes on the one card over gloo with CUDA tensors (NCCL
    refuses two ranks on one card): the toy GAN step with R1 and the path
    length (mbstd over the ranks) and two classifier steps (global
    BatchNorm) against the same steps in this process at the global batch
    (fp32, TF32 off): the metrics within 1e-4, the GAN's first moments (the
    averaged gradients) within 1e-2 of each leaf's scale (a pre-activation
    within rounding of lrelu's kink may take the other slope), at most
    1e-3 of the parameter elements off by over 1 % of lr (Adam steps each
    element by about lr whatever its gradient's size); the classifier's
    losses within 1e-4, its parameters likewise (1e-3 of the elements off
    by over 1 % of lr) and its running statistics within 1e-3 of their
    scale."""
    from torch_dp_worker import (
        classifier_inputs,
        gan_inputs,
        relative,
        run_classifier_steps,
        run_gan_steps,
        run_ranks,
        to_device,
    )

    def gan_step():
        inp = gan_inputs()
        return dict(inp, steps=inp["steps"][:1], images=inp["images"][:1])

    outs = run_ranks(tmp_path, {"gan_steps": gan_step(), "classifier_steps": classifier_inputs()},
                     world=2, timeout=600, device="cuda:0")
    ref = to_device(run_gan_steps(to_device(gan_step(), cuda), None), "cpu")
    lr = 2.5e-3  # GANTrainingParams.learning_rate
    for out in outs:
        got = out["gan_steps"]
        for k, v in ref["metrics"][0].items():
            assert abs(got["metrics"][0][k] - v) <= 1e-4 * max(abs(v), 1e-3), k
        for n, t in ref["exp_avg"].items():
            assert relative(got["exp_avg"][n], t) < 1e-2, n
        off = total = 0
        for part in ("g", "d"):
            for n, t in ref[part].items():
                if t.is_floating_point():
                    off += int(((got[part][n] - t).abs() > 0.01 * lr).sum())
                    total += t.numel()
        assert off <= 1e-3 * total, (off, total)
    cls = to_device(run_classifier_steps(to_device(classifier_inputs(), cuda), None), "cpu")
    for out in outs:
        got = out["classifier_steps"]["state"]
        np.testing.assert_allclose(np.asarray(out["classifier_steps"]["losses"]),
                                   np.asarray(cls["losses"]), rtol=1e-4)
        off = total = 0
        for n, t in cls["state"].items():
            if "running" in n:
                assert relative(got[n], t) < 1e-3, n
            elif t.is_floating_point():
                off += int(((got[n] - t).abs() > 1e-5).sum())  # 1 % of Adam's lr, 1e-3
                total += t.numel()
        assert off <= 1e-3 * total, (off, total)


def test_toy_clip_and_adapter_on_the_card_match_the_cpu(cuda, tmp_path, monkeypatch):
    """A toy CLIP (width 64, 2 layers; patch 8 at 32²) and a Concept2CLIP
    adapter from the same weights on the card (TF32 off) and on the CPU:
    both preprocessings, both encoders and the adapter within 1e-4 of the
    scale; then the image embedding pass on the card, padded last batch
    included, against the CPU's."""
    from viscoin_tpu_torch.data.datasets import SyntheticDataset
    from viscoin_tpu_torch.models.clip import CLIP, clip_preprocess_u8, compute_image_embeddings
    from viscoin_tpu_torch.models.concept2clip import Concept2CLIP
    from viscoin_tpu_torch.utils.weights import module_to_jax_tree

    def toy(device, image_size=32):
        return CLIP(image_width=64, image_layers=2, image_heads=4, patch_size=8,
                    image_size=image_size, vocab_size=560, context_length=16, text_width=64,
                    text_layers=2, text_heads=4, device=device)

    def rel(got, want):
        return float((got.cpu() - want).abs().max() / want.abs().max())

    rng = np.random.default_rng(0)
    cpu = init_models(toy("cpu"), 0)
    card = toy(cuda)
    card.load_state_dict(cpu.state_dict())
    u8 = torch.from_numpy(rng.integers(0, 256, (3, 48, 40, 3), dtype=np.uint8))
    tokens = torch.from_numpy(rng.integers(1, 550, (3, 16)))
    tokens[:, 9:] = 0
    tokens[:, 8] = 559
    with torch.no_grad():
        x = clip_preprocess_u8(u8, 32)
        assert rel(clip_preprocess_u8(u8.to(cuda), 32), x) <= 1e-5
        assert rel(card.encode_image(x.to(cuda)), cpu.encode_image(x)) <= 1e-4
        assert rel(card.encode_text(tokens.to(cuda)), cpu.encode_text(tokens)) <= 1e-4
        adapter = init_models(Concept2CLIP(n_concepts=16, device="cpu"), 1)
        on_card = Concept2CLIP(n_concepts=16, device=cuda)
        on_card.load_state_dict(adapter.state_dict())
        phi = torch.from_numpy(rng.standard_normal((4, 3, 3, 16)).astype(np.float32))
        assert rel(on_card(phi.to(cuda)), adapter(phi)) <= 1e-4
    kw = dict(n_classes=3, image_size=40, transform="test")
    train, test = SyntheticDataset(n=5, **kw), SyntheticDataset(n=3, mode="test", **kw)
    cpu = init_models(toy("cpu", image_size=224), 3)
    card = toy(cuda, image_size=224)
    params = module_to_jax_tree(cpu)["params"]
    embs = []
    for clip, where in ((card, "card"), (cpu, "cpu")):
        (tmp_path / where).mkdir()
        monkeypatch.chdir(tmp_path / where)
        embs.append(compute_image_embeddings(clip, "synthetic", train, test, params=params,
                                             batch_size=4))
    for got, want in zip(*embs):
        assert got.shape == want.shape and rel(torch.from_numpy(got),
                                               torch.from_numpy(want)) <= 1e-4
