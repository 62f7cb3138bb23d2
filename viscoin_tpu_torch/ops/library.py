"""The hand-written kernels as registered torch operators.

``viscoin::bias_act``, ``viscoin::bias_act_grad`` and ``viscoin::upfirdn2d``
are defined here with ``torch.library``, so that a traced program
(``torch.export``, ``serve/export.py``) can hold the kernels as operators and
a loaded program can launch them. Each has:

  * a CUDA implementation: the kernel's launch in ``ops/bias_act.py``
    (``_bias_act_cuda``, ``_bias_act_grad_cuda``) or ``ops/upfirdn2d.py``
    (``_upfirdn2d_cuda``). Everything that reads a data pointer, the stream
    or an alignment happens there, at launch time, and ``_kernels.check``
    counts the launch there and nowhere else. It never runs the plain
    version: a CUDA tensor launches the kernel or raises;
  * a CPU implementation: the plain version, its output contiguous
    (``_bias_act_cpu``, ``_bias_act_grad_cpu``, ``_upfirdn2d_cpu``);
  * a fake implementation giving the output's shape and type: x's for
    bias_act and dx, b's for db (None without a bias or when not
    ``need_db``), and for upfirdn2d the plane of ``fir_plan``'s padding
    arithmetic (:func:`~viscoin_tpu_torch.ops.upfirdn2d.output_size`).

Scalars travel as scalars (``str act, float? alpha, float gain, float?
clamp``), the taps as ``float[]`` and ``up``, ``down``, ``padding`` as
``int[]`` ((y, x), (y, x) and (x0, x1, y0, y1)).

Eager calls do not go through the dispatcher: the ``autograd.Function``s of
the two op modules call the same implementation functions directly, by
device, and take ``torch.ops.viscoin.*`` only while a program is traced
(:func:`~torch.compiler.is_exporting`). A call through the dispatcher with
a Python implementation costs an H100's host 5-21 µs more than a direct
call (PERF.md, Findings), and a reconstruct batch makes 400+ of them.
"""

from __future__ import annotations

import torch

from viscoin_tpu_torch.ops import bias_act as _ba
from viscoin_tpu_torch.ops import upfirdn2d as _up

NAMESPACE = "viscoin"

_lib = torch.library.Library(NAMESPACE, "DEF")
_lib.define("bias_act(Tensor x, Tensor? b, str act, float? alpha, float gain, float? clamp) "
            "-> Tensor")
_lib.define("bias_act_grad(Tensor x, Tensor? b, Tensor dy, Tensor? dy_add, str act, "
            "float? alpha, float gain, float? clamp, bool need_db) -> (Tensor, Tensor?)")
_lib.define("upfirdn2d(Tensor x, float[] taps, int[] up, int[] down, int[] padding, "
            "bool flip_filter, float gain) -> Tensor")


# (op, dispatch key) -> implementation, each taking the operator's
# arguments in the schema's order; the tests read this table.
IMPLS = {
    ("bias_act", "CUDA"): _ba._bias_act_cuda,
    ("bias_act_grad", "CUDA"): _ba._bias_act_grad_cuda,
    ("upfirdn2d", "CUDA"): _up._upfirdn2d_cuda,
    ("bias_act", "CPU"): _ba._bias_act_cpu,
    ("bias_act_grad", "CPU"): _ba._bias_act_grad_cpu,
    ("upfirdn2d", "CPU"): _up._upfirdn2d_cpu,
}
for (_op, _key), _fn in IMPLS.items():
    _lib.impl(_op, _fn, _key)


@torch.library.register_fake(f"{NAMESPACE}::bias_act", lib=_lib)
def _bias_act_fake(x, b, act, alpha, gain, clamp):
    return x.new_empty(x.shape)


@torch.library.register_fake(f"{NAMESPACE}::bias_act_grad", lib=_lib)
def _bias_act_grad_fake(x, b, dy, dy_add, act, alpha, gain, clamp, need_db):
    db = b.new_empty((x.shape[1],)) if b is not None and need_db else None
    return x.new_empty(x.shape), db


@torch.library.register_fake(f"{NAMESPACE}::upfirdn2d", lib=_lib)
def _upfirdn2d_fake(x, taps, up, down, padding, flip_filter, gain):
    ho, wo = _up.output_size(x.shape[2], x.shape[3], len(taps), up, down, padding)
    return x.new_empty((x.shape[0], x.shape[1], ho, wo))
