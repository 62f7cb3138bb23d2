"""The benchmark's own counters by hand arithmetic at toy shapes, and the
reference's hand-written backwards against plain autograd."""

from __future__ import annotations

import torch

from perfbench.harness.counting import Counted, FlopCount, total
from perfbench.reference import ops
from perfbench.reference.ops import ByteCounter


def test_bias_act_bytes_forward_and_backward():
    x = torch.randn(2, 3, 4, 4, requires_grad=True)
    b = torch.randn(3, requires_grad=True)
    with ByteCounter() as c:
        y = ops.bias_act(x, b, act="lrelu")
    assert c.bytes["bias_act"] == (96 + 3 + 96) * 4  # x, b, y
    with ByteCounter() as c:
        y.sum().backward()
    assert c.bytes["bias_act"] == (96 + 96 + 3 + 96 + 3) * 4  # dy, x, b -> dx, db


def test_upfirdn2d_bytes_forward_and_adjoint():
    x = torch.randn(1, 2, 4, 4, requires_grad=True)
    f = ops.setup_filter([1, 3, 3, 1])
    with ByteCounter() as c:
        y = ops.upsample2d(x, f)
    assert y.shape == (1, 2, 8, 8)
    assert c.bytes["upfirdn2d"] == (32 + 128) * 4
    with ByteCounter() as c:
        y.sum().backward()
    assert c.bytes["upfirdn2d"] == (128 + 32) * 4 and c.calls["upfirdn2d"] == 1


def test_flops_of_a_product_and_a_convolution_with_their_backward():
    a = torch.randn(4, 5, requires_grad=True)
    w = torch.randn(5, 6)
    with FlopCount() as fc:
        (a @ w).sum().backward()
    assert fc.get_total_flops() == 2 * 4 * 5 * 6 * 2  # forward, and the gradient of a
    x = torch.randn(1, 3, 8, 8)
    k = torch.randn(4, 3, 3, 3)
    with FlopCount() as fc:
        torch.nn.functional.conv2d(x, k, padding=1)
    assert fc.get_total_flops() == 2 * (4 * 8 * 8) * (3 * 3 * 3)


def test_counted_and_total_scale_by_the_mix():
    store = {}
    x = torch.randn(2, 3, 4, 4)
    with Counted(True, store, "a"):
        ops.bias_act(x, None)
        torch.randn(2, 2) @ torch.randn(2, 2)
    with Counted(False, store, "b"):
        ops.bias_act(x, None)
    assert set(store) == {"a"}
    flops, nbytes = total(store, {"a": 3})
    assert flops == 3 * 16 and nbytes == {"bias_act": 3 * 192 * 4, "upfirdn2d": 0}


def test_fir_backward_is_the_adjoint_and_differentiable_again():
    torch.manual_seed(0)
    f = ops.setup_filter([1, 3, 3, 1]).double()
    x = torch.randn(2, 3, 9, 9, dtype=torch.float64, requires_grad=True)
    for kw in ({"up": 2, "padding": (2, 1, 2, 1), "gain": 4.0}, {"down": 2, "padding": 2},
               {"padding": (-1, 2, 0, 1)}):
        y = ops.upfirdn2d(x, f, **kw)
        want = ops._fir(x, f, kw.get("up", 1), kw.get("down", 1), ops._pads(kw["padding"]),
                        False, kw.get("gain", 1.0))
        assert torch.allclose(y, want)
        g = torch.randn_like(y, requires_grad=True)
        (gx,) = torch.autograd.grad(y, x, g, create_graph=True)
        (want_gx,) = torch.autograd.grad(want, x, g, create_graph=True)
        assert torch.allclose(gx, want_gx)
        h = torch.randn_like(gx)  # the second order: the gradient of gx . h in g
        assert torch.allclose(torch.autograd.grad((gx * h).sum(), g)[0],
                              torch.autograd.grad((want_gx * h).sum(), g)[0])


def test_bias_act_second_order_matches_plain_autograd():
    torch.manual_seed(1)
    x = torch.randn(3, 4, 5, 5, dtype=torch.float64, requires_grad=True)
    b = torch.randn(4, dtype=torch.float64, requires_grad=True)
    w = torch.randn(3, 4, 5, 5, dtype=torch.float64, requires_grad=True)

    def plain(t, b):
        t = t + b[None, :, None, None]
        return torch.where(t >= 0, t, 0.2 * t) * 2**0.5

    def grads(fn):  # an R1-like penalty: the gradient's norm, differentiated again
        (gx,) = torch.autograd.grad(fn(x * w, b).square().sum(), x, create_graph=True)
        return (gx, *torch.autograd.grad(gx.square().sum(), (w, b)))

    got = grads(lambda t, b: ops.bias_act(t, b, act="lrelu"))
    assert all(torch.allclose(a, c) for a, c in zip(got, grads(plain)))
