"""Fused bias + activation (+gain +clamp) over NCHW tensors.

Counterpart of ``viscoin_tpu/ops/bias_act.py``. The bias is broadcast along
dim 1 (channels of NCHW, features of a (B, F) batch). Each activation has a
default gain applied after the nonlinearity; the optional clamp is applied
last as ``clip(y, -clamp, clamp)`` and a negative clamp means none.

Dispatch follows the JAX rule (``impl="pallas"`` only for linear / relu /
lrelu on rank >= 2): those three go through one ``torch.autograd.Function``
whose forward is the hand-written CUDA kernel (``csrc/bias_act.cu``) for a
CUDA tensor and :func:`bias_act_plain` for a CPU tensor, and whose backward
is the hand-written backward kernel of the same source for a CUDA tensor and
:func:`bias_act_grad_plain` for a CPU tensor. The backward is the value of
``jax.grad`` of the JAX package's XLA path, ties included, to first order
only (a second backward raises). The other six activations take the composed
torch path on every device, as in JAX, with torch's autograd. There is no
fallback: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from viscoin_tpu_torch.ops import _kernels


class _ActSpec(NamedTuple):
    fn: Callable[[torch.Tensor], torch.Tensor]
    def_gain: float


activation_funcs: dict[str, _ActSpec] = {
    "linear": _ActSpec(lambda x: x, 1.0),
    "relu": _ActSpec(torch.relu, math.sqrt(2.0)),
    "lrelu": _ActSpec(lambda x: torch.where(x >= 0, x, 0.2 * x), math.sqrt(2.0)),
    "tanh": _ActSpec(torch.tanh, 1.0),
    "sigmoid": _ActSpec(torch.sigmoid, 1.0),
    "elu": _ActSpec(F.elu, 1.0),
    "selu": _ActSpec(F.selu, 1.0),
    "softplus": _ActSpec(F.softplus, 1.0),
    "swish": _ActSpec(F.silu, math.sqrt(2.0)),
}

KERNEL_ACTS = {"linear": 0, "relu": 1, "lrelu": 2}


def bias_act(
    x: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    act: str = "linear",
    alpha: float | None = None,
    gain: float | None = None,
    clamp: float | None = None,
) -> torch.Tensor:
    """Fused bias + activation + gain + clamp.

    Args:
        x: input of rank >= 1; the bias rides dim 1.
        b: optional 1-D bias of length ``x.shape[1]``.
        act: activation name from :data:`activation_funcs`.
        alpha: lrelu slope override (default 0.2).
        gain: overall gain; defaults to the activation's ``def_gain``.
        clamp: if set and >= 0, clip the output to [-clamp, clamp].
    """
    spec = activation_funcs[act]
    gain = spec.def_gain if gain is None else float(gain)
    if clamp is not None and clamp < 0:
        clamp = None
    if act in KERNEL_ACTS and x.ndim >= 2:
        return _BiasAct.apply(x, b, act, alpha, gain, clamp)
    return bias_act_plain(x, b, act=act, alpha=alpha, gain=gain, clamp=clamp)


class _BiasAct(torch.autograd.Function):
    """The kernel activations with their backward: kernels for CUDA tensors,
    the plain versions for CPU tensors. x and b are saved and the
    pre-activation is recomputed in the backward."""

    @staticmethod
    def forward(ctx, x, b, act, alpha, gain, clamp):
        ctx.save_for_backward(x, b)
        ctx.args = dict(act=act, alpha=alpha, gain=gain, clamp=clamp)
        if x.device.type != "cpu":
            return _bias_act_cuda(x, b, **ctx.args)
        return bias_act_plain(x, b, **ctx.args)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, b = ctx.saved_tensors
        need_dx, need_db = ctx.needs_input_grad[:2]
        grad = _bias_act_grad_cuda if x.device.type != "cpu" else bias_act_grad_plain
        dx, db = grad(x, b, dy, need_db=need_db, **ctx.args)
        return (dx if need_dx else None), db, None, None, None, None


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 for fp32 and narrower types (what the kernel computes in);
    float64 stays float64, so gradcheck can run on the plain versions."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _bias_view(b: torch.Tensor, x: torch.Tensor, ct: torch.dtype) -> torch.Tensor:
    """The bias as the kernel reads it: rounded to x's type, then computed
    in ``ct``, shaped to broadcast along dim 1."""
    shape = [1] * x.ndim
    shape[1] = -1
    return b.to(x.dtype).to(ct).reshape(shape)


def _activate(t: torch.Tensor, act: str, alpha) -> torch.Tensor:
    if act == "lrelu" and alpha is not None and alpha != 0.2:
        return torch.where(t >= 0, t, alpha * t)
    return activation_funcs[act].fn(t)


def bias_act_plain(x, b=None, *, act="linear", alpha=None, gain=None, clamp=None):
    """The plain torch version: the same function, computed in fp32 and cast
    back to ``x.dtype`` (what the kernel does)."""
    spec = activation_funcs[act]
    gain = spec.def_gain if gain is None else float(gain)
    if clamp is not None and clamp < 0:
        clamp = None
    ct = _compute_dtype(x.dtype)
    y = x.to(ct)
    if b is not None:
        y = y + _bias_view(b, x, ct)
    y = _activate(y, act, alpha)
    if gain != 1.0:
        y = y * gain
    if clamp is not None:
        y = y.clamp(-clamp, clamp)
    return y.to(x.dtype)


def bias_act_grad_plain(x, b, dy, *, act, alpha=None, gain, clamp=None, need_db=True):
    """The plain version of the backward kernel, for linear / relu / lrelu:
    ``(dx, db)`` with dx = dy * clip'(y0) * gain * act'(t) (t = x + b,
    y0 = gain * act(t)) in x's type and db = sum of dx over every dim but 1
    in b's type and device (None without a bias or when not ``need_db``).
    Ties take jax.grad's values: relu'(0) = 1/2, lrelu'(0) = 1, and
    clip' = 1/2 at y0 = -clamp or +clamp."""
    ct = _compute_dtype(x.dtype)
    t = x.to(ct)
    if b is not None:
        t = t + _bias_view(b, x, ct)
    g = dy.to(ct)
    half = torch.tensor(0.5, dtype=ct, device=x.device)
    if clamp is not None and clamp >= 0:
        y = _activate(t, act, alpha) * gain
        m = torch.clamp_min(y, -clamp)
        lo = torch.where(y > -clamp, 1.0, torch.where(y == -clamp, half, 0.0))
        hi = torch.where(m < clamp, 1.0, torch.where(m == clamp, half, 0.0))
        g = g * (lo * hi)
    g = g * gain
    if act == "relu":
        g = g * torch.where(t > 0, 1.0, torch.where(t == 0, half, 0.0))
    elif act == "lrelu":
        g = torch.where(t >= 0, g, g * (0.2 if alpha is None else alpha))
    elif act != "linear":
        raise ValueError(f"the bias_act backward takes linear, relu or lrelu, not {act!r}")
    db = None
    if b is not None and need_db:
        db = g.sum(dim=[d for d in range(g.ndim) if d != 1]).to(dtype=b.dtype, device=b.device)
    return g.to(x.dtype), db


# --------------------------------------------------------------------------- #
# The kernel's launch plan (csrc/bias_act.cu), decided here where the CPU     #
# tests reach it.                                                             #
# --------------------------------------------------------------------------- #

BIAS_ACT_THREADS = 256  # threads per block (block_x * block_y)
BIAS_ACT_ITEMS = 4      # kItems: vectors per thread along its row


class _BiasActParams(ctypes.Structure):
    """The kernel's by-value parameter block: ``Plan`` in csrc/bias_act.cu."""

    _fields_ = [("rows", ctypes.c_longlong), ("row_len", ctypes.c_longlong),
                ("blocks", ctypes.c_longlong)] + [
        (name, ctypes.c_int) for name in (
            "channels", "bias_mode", "vec", "block_x", "block_y", "chunks", "act", "is_bf16")
    ] + [(name, ctypes.c_float) for name in ("alpha", "gain", "clamp")]


class BiasActPlan(NamedTuple):
    """How one bias_act call is cut into blocks. A row is one (n, c) plane
    (``bias_mode`` 0, bias of row % C) or, where the plane is one element
    ((B, F) features), one sample (``bias_mode`` 1, bias of the column)."""

    rows: int
    row_len: int
    channels: int
    bias_mode: int
    vec: int        # elements per access: 16 bytes, or 1 (scalar variant)
    block_x: int    # threads along a row
    block_y: int    # rows per block
    chunks: int     # chunks of block_x * BIAS_ACT_ITEMS vectors per row
    blocks: int


def bias_act_plan(shape: tuple[int, ...], is_bf16: bool, aligned: bool) -> BiasActPlan:
    """Plan the kernel's launch for an input of ``shape`` (rank >= 2, bias
    on dim 1). ``aligned``: every pointer the vector accesses touch is
    16-byte aligned (:func:`vector_aligned`)."""
    channels = shape[1]
    hw = math.prod(shape[2:])
    if hw == 1:
        rows, row_len, mode = shape[0], channels, 1
    else:
        rows, row_len, mode = shape[0] * channels, hw, 0
    width = 8 if is_bf16 else 4
    vec = width if aligned and row_len % width == 0 else 1
    nvec = row_len // vec
    block_x = min(BIAS_ACT_THREADS, 1 << max(0, nvec - 1).bit_length())
    block_y = BIAS_ACT_THREADS // block_x
    chunks = -(-nvec // (block_x * BIAS_ACT_ITEMS))
    blocks = -(-rows // block_y) * chunks
    if row_len >= 2**31 or rows >= 2**31 or blocks >= 2**31:
        raise ValueError(f"bias_act kernel: shape {shape} exceeds its 32-bit indexing")
    return BiasActPlan(rows, row_len, channels, mode, vec, block_x, block_y, chunks, blocks)


def vector_aligned(x: torch.Tensor, b: torch.Tensor | None, *others: torch.Tensor) -> bool:
    """Whether the 16-byte variant may touch these tensors: x and the others
    (the output; dy and dx in the backward) always, the bias where it is
    loaded as a vector (one value per column)."""
    ptrs = x.data_ptr()
    for t in others:
        ptrs |= t.data_ptr()
    if b is not None and math.prod(x.shape[2:]) == 1:
        ptrs |= b.data_ptr()
    return ptrs % 16 == 0


@functools.lru_cache(maxsize=1024)
def _params(shape, is_bf16, aligned, act, alpha, gain, clamp) -> _BiasActParams:
    plan = bias_act_plan(shape, is_bf16, aligned)
    return _BiasActParams(rows=plan.rows, row_len=plan.row_len, blocks=plan.blocks,
                          channels=plan.channels, bias_mode=plan.bias_mode, vec=plan.vec,
                          block_x=plan.block_x, block_y=plan.block_y, chunks=plan.chunks,
                          act=KERNEL_ACTS[act], is_bf16=int(is_bf16),
                          alpha=0.2 if alpha is None else alpha, gain=gain,
                          clamp=-1.0 if clamp is None else clamp)


def _kernel_inputs(name: str, x, b):
    """Check and prepare the kernels' common inputs: x contiguous, the bias
    in x's type and device."""
    if not x.is_cuda:
        raise ValueError(f"{name} kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {x.dtype}")
    x = x.contiguous()
    if b is not None:
        if b.shape != (x.shape[1],):
            raise ValueError(f"bias shape {tuple(b.shape)} != ({x.shape[1]},)")
        if b.dtype != x.dtype or b.device != x.device or not b.is_contiguous():
            b = b.to(device=x.device, dtype=x.dtype).contiguous()
    return x, b


def _kernel_params(x, aligned, act, alpha, gain, clamp) -> _BiasActParams:
    return _params(tuple(x.shape), x.dtype == torch.bfloat16, aligned, act,
                   None if alpha is None else float(alpha), float(gain),
                   None if clamp is None else float(clamp))


def _bias_act_cuda(x, b, *, act, alpha, gain, clamp):
    x, b = _kernel_inputs("bias_act", x, b)
    fn = _kernels.entry("bias_act")
    y = torch.empty_like(x)
    params = _kernel_params(x, vector_aligned(x, b, y), act, alpha, gain, clamp)
    rc = fn(x.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
            ctypes.addressof(params), _kernels.current_stream(x))
    _kernels.check("bias_act", rc)
    return y


def _bias_act_grad_cuda(x, b, dy, *, act, alpha, gain, clamp, need_db=True):
    """The backward kernel: ``(dx, db)`` as :func:`bias_act_grad_plain`
    returns them. ``dy`` may be any layout (autograd hands over expanded
    and non-contiguous gradients); it is made contiguous in x's type."""
    b_orig = b
    x, b = _kernel_inputs("bias_act_grad", x, b)
    fn = _kernels.entry("bias_act_grad")
    if dy.shape != x.shape:
        raise ValueError(f"dy shape {tuple(dy.shape)} != x shape {tuple(x.shape)}")
    dy = dy.to(device=x.device, dtype=x.dtype).contiguous()
    dx = torch.empty_like(x)
    db = None
    if b is not None and need_db:
        db = torch.zeros(x.shape[1], device=x.device, dtype=torch.float32)
    params = _kernel_params(x, vector_aligned(x, b, dy, dx), act, alpha, gain, clamp)
    rc = fn(x.data_ptr(), None if b is None else b.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            None if db is None else db.data_ptr(), ctypes.addressof(params),
            _kernels.current_stream(x))
    _kernels.check("bias_act_grad", rc)
    if db is not None:
        db = db.to(dtype=b_orig.dtype, device=b_orig.device)
    return dx, db
