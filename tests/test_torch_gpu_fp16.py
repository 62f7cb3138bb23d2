"""Card-only tests of the kernels' float16 instantiations at the shapes of
the 1024² mixed-precision GAN cell (stylegan2-ada-pytorch's ``paper1024``:
batch 4, the blocks at 128²-1024² in float16): ``upfirdn2d`` forward and
adjoint, and ``bias_act`` / ``bias_act_grad`` to second order, against
their plain versions, and a mixed-precision GAN step on the card against
the same step on the CPU.

Imports torch and the port only (no JAX):

    python -m pytest tests/test_torch_gpu_fp16.py -m gpu -q --noconftest -p no:cacheprovider

Without a card every test skips (the check is made inside a fixture).
"""

import math

import pytest
import torch

from viscoin_tpu_torch.ops import _kernels, bias_act, setup_filter, upfirdn2d
from viscoin_tpu_torch.ops.bias_act import _bias_act_grad_cuda, bias_act_grad_plain, bias_act_plain
from viscoin_tpu_torch.ops.upfirdn2d import upfirdn2d_plain

pytestmark = pytest.mark.gpu

F1D = [1.0, 3.0, 3.0, 1.0]
CELL_FIR = [  # the float16 blocks' FIR calls at batch 4
    ((4, 32, 1025, 1025), dict(up=1, down=1, padding=1, gain=4.0)),  # G 1024², after the up-conv
    ((4, 256, 129, 129), dict(up=1, down=1, padding=1, gain=4.0)),   # G 128²
    ((4, 32, 1024, 1024), dict(up=1, down=1, padding=2, gain=1.0)),  # D 1024², conv1's FIR
    ((4, 32, 1024, 1024), dict(up=1, down=1, padding=1, gain=1.0)),  # D 1024², the skip's FIR
]
CELL_BIAS_ACT = [(4, 32, 1024, 1024), (4, 256, 128, 128), (4, 512), (4, 512, 4, 4), (3, 5, 7, 3)]
CLAMP = 256.0
GRAD_KW = [dict(act="lrelu", alpha=None, gain=math.sqrt(2.0), clamp=CLAMP),
           dict(act="lrelu", alpha=None, gain=math.sqrt(2.0) * math.sqrt(0.5),
                clamp=CLAMP * math.sqrt(0.5)),
           dict(act="linear", alpha=None, gain=1.0, clamp=CLAMP),
           dict(act="lrelu", alpha=None, gain=math.sqrt(2.0), clamp=None)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def assert_fp16_close(got, want, ulps: float = 2.0):
    """Within ``ulps`` float16 units of the output's scale: the kernel sums
    in fp32 and rounds once, as the plain version of the upcast input does
    (in another order)."""
    assert got.dtype == torch.float16 and got.shape == want.shape
    scale = max(1.0, float(want.float().abs().max()))
    err = float((got.detach().float() - want.float()).abs().max())
    assert err <= ulps * 2.0**-10 * scale, (err, scale)


@pytest.mark.parametrize("shape,case", CELL_FIR, ids=[f"{s}-p{c['padding']}" for s, c in CELL_FIR])
def test_upfirdn2d_fp16_forward_and_adjoint_at_cell_shapes(cuda, shape, case):
    """The forward against the plain version of the upcast input rounded to
    float16 and against the plain float16 path; the backward is the adjoint
    (one more launch), against the plain adjoint, and <y, A x> = <A^T y, x>
    holds in float64 on the float16 values to their rounding."""
    g = torch.Generator(device=cuda).manual_seed(21)
    f = setup_filter(F1D)
    x = torch.randn(shape, device=cuda, generator=g).half().requires_grad_()
    _kernels.reset_launch_counts()
    y = upfirdn2d(x, f, **case)
    assert_fp16_close(y, upfirdn2d_plain(x.detach().float(), f, **case).half())
    assert_fp16_close(y, upfirdn2d_plain(x.detach(), f, **case), ulps=4.0)
    dy = torch.randn(y.shape, device=cuda, generator=g).half()
    y.backward(dy)
    assert _kernels.launch_counts()["upfirdn2d"] == 2
    xf = x.detach().float().requires_grad_()
    upfirdn2d_plain(xf, f, **case).backward(dy.float())
    assert_fp16_close(x.grad, xf.grad.half())
    terms_l = y.detach().double() * dy.double()
    terms_r = x.detach().double() * x.grad.double()
    slack = 2.0**-10 * float(terms_l.abs().sum() + terms_r.abs().sum())
    assert abs(float(terms_l.sum() - terms_r.sum())) <= slack


@pytest.mark.parametrize("shape", CELL_BIAS_ACT, ids=str)
def test_bias_act_fp16_forward_and_gradients_are_the_plain_versions(cuda, shape):
    """Forward, gradient (with the deterministic db) and second order (dy_add)
    of the float16 instantiations, aligned and misaligned, with the cell's
    clamp 256 · gain: dx and y bit-equal to the plain versions (fp32
    arithmetic, one rounding), db within 1e-5 of its scale; values on a
    grid that hits the clamp and the ties."""
    g = torch.Generator(device=cuda).manual_seed(22)
    n = math.prod(shape)
    base = (torch.randint(-4096, 4097, (n + 1,), device=cuda, generator=g) / 8).half()
    dy = torch.randn(shape, device=cuda, generator=g).half()
    b = (torch.randint(-8, 9, (shape[1] + 1,), device=cuda, generator=g) / 8).float()
    add = torch.randn(shape[1], device=cuda, generator=g)
    for x, bias in ((base[:-1].view(shape), b[:-1]), (base[1:].view(shape), b[1:])):
        for kw in GRAD_KW:
            y = bias_act(x, bias, **kw)
            assert y.dtype == torch.float16 and torch.equal(y, bias_act_plain(x, bias, **kw))
            dx, db = _bias_act_grad_cuda(x, bias, dy, None, **kw)
            want_dx, want_db = bias_act_grad_plain(x, bias, dy, **kw)
            assert dx.dtype == torch.float16 and torch.equal(dx, want_dx), kw
            scale = max(1.0, float(want_db.abs().max()))
            assert float((db - want_db).abs().max()) <= 1e-5 * scale, kw
            dx2, _ = _bias_act_grad_cuda(x, bias, dy, dy_add=add, need_db=False, **kw)
            want2, _ = bias_act_grad_plain(x, bias, dy, dy_add=add, need_db=False, **kw)
            assert torch.equal(dx2, want2), kw


def test_bias_act_fp16_second_order_through_autograd(cuda):
    """R1's path through a float16 activation: the gradient of a gradient,
    each a launch of the backward kernel, equal to the same graph on the
    plain versions (the CPU) to float16 rounding (the squared sums reduce
    in another order there)."""
    g = torch.Generator(device=cuda).manual_seed(23)
    x = torch.randn(4, 32, 64, 64, device=cuda, generator=g).half().requires_grad_()
    b = torch.randn(32, device=cuda, generator=g).requires_grad_()

    def second(x, b):
        (gx,) = torch.autograd.grad(bias_act(x, b, act="lrelu", clamp=2.0).float().square().sum(),
                                    x, create_graph=True)
        return torch.autograd.grad(gx.float().square().sum(), (x,))[0]

    _kernels.reset_launch_counts()
    got = second(x, b)
    assert _kernels.launch_counts()["bias_act_grad"] >= 2
    want = second(x.detach().cpu().requires_grad_(), b.detach().cpu().requires_grad_())
    assert_fp16_close(got.cpu(), want, ulps=4.0)


def test_mixed_precision_gan_step_on_the_card_matches_the_cpu(cuda):
    """A toy paper1024-style step (float16 in the two top blocks, clamp 256,
    path length on half the batch, the sanitizer) with both regularisers on
    the card and on the CPU from the same weights and draws: losses within
    2e-2 relative (float16 activations, convolutions in another order),
    every block counted in its dtype, no gradient element replaced."""
    from viscoin_tpu_torch.models.bundle import init_models
    from viscoin_tpu_torch.models.stylegan import Discriminator, Generator
    from viscoin_tpu_torch.train import gan as T
    from viscoin_tpu_torch.utils import tracing

    def run(device):
        G = init_models(Generator(z_dim=32, w_dim=32, img_resolution=64, channel_base=1024,
                                  channel_max=64, mapping_layers=8, conv_clamp=256.0,
                                  num_fp16_res=2, device="cpu"), 0).to(device)
        D = init_models(Discriminator(img_resolution=64, channel_base=1024, channel_max=64,
                                      conv_clamp=256.0, num_fp16_res=2, device="cpu"),
                        1).to(device)
        # lr 0: both D phases see the same generator (noise strengths are 0 at init).
        cfg = T.GANTrainingParams(batch_size=4, compute_dtype="float32", augment="ada",
                                  augment_p=0.2, pl_batch_shrink=2, learning_rate=0.0,
                                  r1_gamma=2.0)
        state = T.create_gan_train_state(G, D, cfg)
        step = T.make_gan_train_step(G, D, cfg)
        images = torch.randint(0, 256, (4, 64, 64, 3), dtype=torch.uint8,
                               generator=torch.Generator().manual_seed(5)).to(device)
        draws = T.draw_step(cfg, G, 7, 0, "cpu").to(device)
        tracing.reset_precision_counts()
        _, m = step(state, images, draws)
        return {k: float(v) for k, v in m.items()}, tracing.precision_counts()

    card, counts = run(cuda)
    cpu, _ = run(torch.device("cpu"))
    for k in ("g_loss", "d_loss", "r1", "pl_lengths"):
        assert abs(card[k] - cpu[k]) <= 2e-2 * max(abs(cpu[k]), 1e-3), (k, card[k], cpu[k])
    assert counts["blocks.fp16.g64"] and counts["blocks.fp16.d32"] and counts["blocks.fp32.g16"]
    assert counts["grad_nonfinite"] == 0
