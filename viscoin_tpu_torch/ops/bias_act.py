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


def _bias_act_cuda(x, b, *, act, alpha, gain, clamp):
    if not x.is_cuda:
        raise ValueError(f"bias_act kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bias_act kernel takes float32 or bfloat16, got {x.dtype}")
    fn = _kernels.entry("bias_act")
    x = x.contiguous()
    channels = x.shape[1]
    hw = math.prod(x.shape[2:])
    if b is not None:
        if b.shape != (channels,):
            raise ValueError(f"bias shape {tuple(b.shape)} != ({channels},)")
        b = b.to(device=x.device, dtype=x.dtype).contiguous()
    y = torch.empty_like(x)
    rc = fn(x.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
            x.numel(), channels, hw, KERNEL_ACTS[act],
            0.2 if alpha is None else float(alpha), gain,
            -1.0 if clamp is None else float(clamp),
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check("bias_act", rc)
    return y
