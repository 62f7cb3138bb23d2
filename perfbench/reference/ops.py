"""Plain PyTorch versions of the two operations StyleGAN2 builds on: the
fused bias + activation and the FIR resampler upfirdn2d, with the dense and
resampling convolutions around them.

Each operation is an ``autograd.Function`` whose backward is the same
operation again (the FIR's adjoint is an FIR with up and down swapped and
the filter flipped; bias_act's gradient is linear in the incoming gradient),
so every order of differentiation the training steps take is a call of one
of these functions. :class:`ByteCounter` records the bytes each call reads
and writes once; that is what the kernels' rooflines are measured against.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LRELU_ALPHA = 0.2
ACT_GAIN = {"linear": 1.0, "relu": math.sqrt(2.0), "lrelu": math.sqrt(2.0)}

_counters: list["ByteCounter"] = []


class ByteCounter:
    """Inside ``with ByteCounter() as c``: ``c.bytes[op]`` sums the bytes
    every call of ``op`` ("bias_act", "upfirdn2d") reads once and writes
    once, over the forward and every order of its backward."""

    def __init__(self):
        self.bytes = {"bias_act": 0, "upfirdn2d": 0}
        self.calls = {"bias_act": 0, "upfirdn2d": 0}

    def __enter__(self):
        _counters.append(self)
        return self

    def __exit__(self, *exc):
        _counters.remove(self)

    def add(self, op: str, nbytes: int) -> None:
        self.bytes[op] += int(nbytes)
        self.calls[op] += 1


def _count(op: str, *tensors) -> None:
    if _counters:
        n = sum(t.numel() * t.element_size() for t in tensors if t is not None)
        for c in _counters:
            c.add(op, n)


# ------------------------------- bias_act ----------------------------------- #


def _view(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    shape = [1] * x.ndim
    shape[1] = -1
    return v.reshape(shape)


def _act_slope(t: torch.Tensor, act: str) -> torch.Tensor:
    if act == "linear":
        return torch.ones_like(t)
    if act == "relu":
        return (t > 0).to(t.dtype)
    return torch.where(t >= 0, 1.0, LRELU_ALPHA).to(t.dtype)


def _pre(x, b):
    return x if b is None else x + _view(b.to(x.dtype), x)


def _forward(t, act, gain, clamp):
    if act == "relu":
        t = torch.relu(t)
    elif act == "lrelu":
        t = torch.where(t >= 0, t, LRELU_ALPHA * t)
    y = t * gain
    return y if clamp is None else y.clamp(-clamp, clamp)


def _slope(x, b, act, gain, clamp):
    """d y / d x of y = clamp(gain * act(x + b)), elementwise."""
    t = _pre(x, b)
    s = _act_slope(t, act) * gain
    if clamp is not None:
        y = _forward(t, act, gain, None)
        s = s * ((y > -clamp) & (y < clamp)).to(s.dtype)
    return s


class _BiasAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, b, act, gain, clamp):
        ctx.save_for_backward(x, b)
        ctx.args = (act, gain, clamp)
        with torch.no_grad():
            y = _forward(_pre(x, b), act, gain, clamp)
        _count("bias_act", x, b, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, b = ctx.saved_tensors
        return (*_BiasActGrad.apply(dy, x, b, ctx.args, b is not None and ctx.needs_input_grad[1]),
                None, None, None)


class _BiasActGrad(torch.autograd.Function):
    """``(dy, x, b) -> (dx, db)``, linear in dy; its own gradient is the same
    function of the incoming gradients (x and b get none: the slope is
    piecewise constant)."""

    @staticmethod
    def forward(ctx, dy, x, b, args, need_db):
        ctx.save_for_backward(x, b)
        ctx.args = args
        with torch.no_grad():
            dx = dy * _slope(x, b, *args)
            db = dx.sum(dim=[d for d in range(dx.ndim) if d != 1]).to(b.dtype) if need_db else None
        _count("bias_act", dy, x, b, dx, db)
        return dx, db

    @staticmethod
    def backward(ctx, g_dx, g_db):
        x, b = ctx.saved_tensors
        g = g_dx if g_dx is not None else torch.zeros_like(x)
        if g_db is not None:
            g = g + _view(g_db.to(g.dtype), x)
        g_dy, _ = _BiasActGrad.apply(g, x, b, ctx.args, False)
        return g_dy, None, None, None, None


def bias_act(x, b=None, act: str = "linear", gain: float | None = None,
             clamp: float | None = None) -> torch.Tensor:
    """y = clamp(gain * act(x + b)) with the bias along dim 1; ``gain``
    defaults to the activation's (sqrt 2 for relu and lrelu)."""
    gain = ACT_GAIN[act] if gain is None else float(gain)
    if clamp is not None and clamp < 0:
        clamp = None
    return _BiasAct.apply(x, b, act, gain, clamp)


# ------------------------------- upfirdn2d ---------------------------------- #


def setup_filter(taps) -> torch.Tensor:
    """1-D taps normalised to sum 1 (separable: the 2-D filter is their
    outer product)."""
    f = torch.as_tensor(taps, dtype=torch.float32, device="cpu")
    return f / f.sum()


def _pads(padding) -> tuple[int, int, int, int]:
    if isinstance(padding, int):
        return padding, padding, padding, padding
    return tuple(int(p) for p in padding)


def _fir(x, f, up, down, padding, flip, gain):
    """Zero-insert by ``up``, pad (negative: crop) as (x0, x1, y0, y1),
    convolve with the outer product of the taps ``f`` (correlate when
    ``flip``), times ``gain``, keep every ``down``-th sample."""
    px0, px1, py0, py1 = padding
    B, C, H, W = x.shape
    x = x.reshape(B, C, H, 1, W, 1)
    x = F.pad(x, [0, up - 1, 0, 0, 0, up - 1]).reshape(B, C, H * up, W * up)
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    x = x[:, :, max(-py0, 0): x.shape[2] - max(-py1, 0), max(-px0, 0): x.shape[3] - max(-px1, 0)]
    f2 = torch.outer(f, f).to(device=x.device, dtype=x.dtype)
    if not flip:
        f2 = f2.flip([0, 1])
    w = (f2 * gain)[None, None].repeat(C, 1, 1, 1)
    return F.conv2d(x, w, groups=C)[:, :, ::down, ::down]


class _Upfirdn2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, f, up, down, padding, flip, gain):
        ctx.args = (f, up, down, padding, flip, gain)
        ctx.x_shape = x.shape
        with torch.no_grad():
            y = _fir(x, f, up, down, padding, flip, gain)
        _count("upfirdn2d", x, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        f, up, down, padding, flip, gain = ctx.args
        k = f.numel()
        px0, _, py0, _ = padding
        ih, iw = ctx.x_shape[2], ctx.x_shape[3]
        oh, ow = dy.shape[2], dy.shape[3]
        adj = (k - px0 - 1, iw * up - ow * down + px0 - up + 1,
               k - py0 - 1, ih * up - oh * down + py0 - up + 1)
        dx = _Upfirdn2d.apply(dy, f, down, up, adj, not flip, gain)
        return dx, None, None, None, None, None, None


def upfirdn2d(x, f, up: int = 1, down: int = 1, padding=0, flip: bool = False,
              gain: float = 1.0) -> torch.Tensor:
    return _Upfirdn2d.apply(x, f, up, down, _pads(padding), flip, gain)


def upsample2d(x, f, up: int = 2):
    k = f.numel()
    p = ((k + up - 1) // 2, (k - up) // 2)
    return upfirdn2d(x, f, up=up, padding=(p[0], p[1], p[0], p[1]), gain=up * up)


# ------------------------------ convolutions -------------------------------- #


def conv2d_resample(x, w, f=None, up: int = 1, down: int = 1, padding: int = 0,
                    flip_weight: bool = True) -> torch.Tensor:
    """Dense conv (correlation, or true convolution without ``flip_weight``)
    with FIR up- or downsampling: up: transposed conv, then the FIR (gain
    up²); down: the FIR, then the strided conv; padding widened by the
    filter's halo."""
    kh, kw = w.shape[2], w.shape[3]
    k = 1 if f is None else f.numel()
    p = padding
    if up > 1:
        p0, p1 = p + (k + up - 1) // 2, p + (k - up) // 2
        wt = w if not flip_weight else w.flip([2, 3])
        x = F.conv_transpose2d(x, wt.transpose(0, 1), stride=up)
        pad = (p0 - (kw - 1), p1 + up - 1 - (kw - 1), p0 - (kh - 1), p1 + up - 1 - (kh - 1))
        return upfirdn2d(x, f, padding=pad, gain=up * up)
    if not flip_weight:
        w = w.flip([2, 3])
    if down > 1:
        p0, p1 = p + (k - down + 1) // 2, p + (k - down) // 2
        x = upfirdn2d(x, f, padding=(p0, p1, p0, p1))
        return F.conv2d(x, w, stride=down)
    return F.conv2d(x, w, padding=p)


def modulated_conv2d(x, w, styles, noise=None, up: int = 1, padding: int = 0,
                     resample_filter=None, demodulate: bool = True,
                     flip_weight: bool = True) -> torch.Tensor:
    """StyleGAN2's modulated convolution: x scaled by the styles per input
    channel, one dense conv, each output channel scaled by its
    demodulation coefficient, plus the noise."""
    dcoefs = None
    if demodulate:
        dcoefs = torch.rsqrt(styles.square() @ w.square().sum(dim=(2, 3)).T + 1e-8)
    x = x * styles[:, :, None, None]
    x = conv2d_resample(x, w, f=resample_filter, up=up, padding=padding,
                        flip_weight=flip_weight)
    if dcoefs is not None:
        x = x * dcoefs[:, :, None, None]
    return x if noise is None else x + noise
