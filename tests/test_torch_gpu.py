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

import math

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
                dx, db = _bias_act_grad_cuda(x, bias, dy, **kw)
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
        # A second order needs dy to require grad (here dy = 2 y); with a
        # constant dy the second derivative of these piecewise-linear
        # activations is zero and autograd records nothing to raise on.
        (gx,) = torch.autograd.grad(bias_act(x, b, act="lrelu").square().sum(), x,
                                    create_graph=True)
        with pytest.raises(RuntimeError, match="once_differentiable"):
            gx.sum().backward()


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
