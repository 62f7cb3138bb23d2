"""Fused bias + activation (+gain +clamp) over NCHW tensors.

Counterpart of ``viscoin_tpu/ops/bias_act.py``. The bias is broadcast along
dim 1 (channels of NCHW, features of a (B, F) batch). Each activation has a
default gain applied after the nonlinearity; the optional clamp is applied
last as ``clip(y, -clamp, clamp)`` and a negative clamp means none.

Dispatch follows the JAX rule (``impl="pallas"`` only for linear / relu /
lrelu on rank >= 2): those three go to the hand-written CUDA kernel
(``csrc/bias_act.cu``) for a CUDA tensor, and to :func:`bias_act_plain` for
a CPU tensor. The other six activations take the composed torch path on
every device, as in JAX. There is no fallback: a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

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
    if act in KERNEL_ACTS and x.ndim >= 2 and x.device.type != "cpu":
        return _bias_act_cuda(x, b, act=act, alpha=alpha, gain=gain, clamp=clamp)
    return bias_act_plain(x, b, act=act, alpha=alpha, gain=gain, clamp=clamp)


def bias_act_plain(x, b=None, *, act="linear", alpha=None, gain=None, clamp=None):
    """The plain torch version: the same function, computed in fp32 and cast
    back to ``x.dtype`` (what the kernel does)."""
    spec = activation_funcs[act]
    gain = spec.def_gain if gain is None else float(gain)
    if clamp is not None and clamp < 0:
        clamp = None
    y = x.float()
    if b is not None:
        shape = [1] * x.ndim
        shape[1] = -1
        y = y + b.to(x.dtype).float().reshape(shape)
    if act == "lrelu" and alpha is not None and alpha != 0.2:
        y = torch.where(y >= 0, y, alpha * y)
    else:
        y = spec.fn(y)
    if gain != 1.0:
        y = y * gain
    if clamp is not None:
        y = y.clamp(-clamp, clamp)
    return y.to(x.dtype)


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


def vector_aligned(x: torch.Tensor, b: torch.Tensor | None, y: torch.Tensor) -> bool:
    """Whether the 16-byte variant may touch these tensors: x and y always,
    the bias where it is loaded as a vector (one value per column)."""
    ptrs = x.data_ptr() | y.data_ptr()
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


def _bias_act_cuda(x, b, *, act, alpha, gain, clamp):
    if not x.is_cuda:
        raise ValueError(f"bias_act kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bias_act kernel takes float32 or bfloat16, got {x.dtype}")
    fn = _kernels.entry("bias_act")
    x = x.contiguous()
    if b is not None:
        if b.shape != (x.shape[1],):
            raise ValueError(f"bias shape {tuple(b.shape)} != ({x.shape[1]},)")
        if b.dtype != x.dtype or b.device != x.device or not b.is_contiguous():
            b = b.to(device=x.device, dtype=x.dtype).contiguous()
    y = torch.empty_like(x)
    params = _params(tuple(x.shape), x.dtype == torch.bfloat16, vector_aligned(x, b, y), act,
                     None if alpha is None else float(alpha), float(gain),
                     None if clamp is None else float(clamp))
    rc = fn(x.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
            ctypes.addressof(params), _kernels.current_stream(x))
    _kernels.check("bias_act", rc)
    return y
