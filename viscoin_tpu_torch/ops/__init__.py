"""Compute ops. ``bias_act`` and ``upfirdn2d`` launch hand-written CUDA
kernels (``csrc/``) for CUDA tensors and run their plain torch versions for
CPU tensors; dense convolutions are cuDNN. Importing this package registers
the kernels as the operators ``viscoin::bias_act``, ``viscoin::bias_act_grad``
and ``viscoin::upfirdn2d`` (``ops/library.py``), which a loaded
``torch.export`` program needs."""

from viscoin_tpu_torch.ops import library  # noqa: F401 - registers viscoin::*
from viscoin_tpu_torch.ops.bias_act import activation_funcs, bias_act
from viscoin_tpu_torch.ops.conv2d_resample import conv2d, conv2d_resample
from viscoin_tpu_torch.ops.modulated_conv import modulated_conv2d
from viscoin_tpu_torch.ops.upfirdn2d import (
    downsample2d,
    setup_filter,
    upfirdn2d,
    upsample2d,
)

__all__ = [
    "activation_funcs",
    "bias_act",
    "conv2d",
    "conv2d_resample",
    "modulated_conv2d",
    "downsample2d",
    "setup_filter",
    "upfirdn2d",
    "upsample2d",
]
