"""Card-only tests of the PyTorch port: each hand-written kernel against its
plain torch version at the serving path's shapes, and a toy engine on the
card against the same engine on the CPU.

This file imports torch and the port only (no JAX), so it runs on a machine
that has a card but no JAX:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest -p no:cacheprovider

Without a card every test skips (the check is made inside a fixture).
"""

import numpy as np
import pytest
import torch

from viscoin_tpu_torch.models.bundle import default_models
from viscoin_tpu_torch.ops import _kernels, bias_act, setup_filter, upfirdn2d
from viscoin_tpu_torch.ops.bias_act import bias_act_plain
from viscoin_tpu_torch.ops.upfirdn2d import upfirdn2d_plain
from viscoin_tpu_torch.serve.engine import InferenceEngine

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
