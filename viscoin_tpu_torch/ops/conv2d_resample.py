"""2-D convolution with optional up/down resampling, NCHW / OIHW.

Counterpart of ``viscoin_tpu/ops/conv2d_resample.py``. Dense convolutions are
``F.conv2d`` / ``F.conv_transpose2d`` (cuDNN on the card); the FIR
resampling is :func:`~viscoin_tpu_torch.ops.upfirdn2d.upfirdn2d` (the
hand-written kernel on the card).

Semantics match the JAX package:
    - the padding is widened by the resampling filter's halo;
    - up > 1: transposed conv first, then the FIR with gain ``up**2``;
    - down > 1: FIR (with the padding) first, then a strided conv;
    - no resampling: the padding folds straight into the dense conv.
``flip_weight=True`` is correlation (torch ``conv2d``); the StyleGAN
up-convolution passes ``flip_weight=False`` (true convolution).

The up path: JAX runs an lhs-dilated correlation of the input, padded by
``(p0, p1 + up - 1)`` on each axis, with the spatially flipped weight
(``flip_weight=False``). ``F.conv_transpose2d(x, w, stride=up)`` is the full
true convolution of the dilated input with ``w``, which is that same
correlation with ``K - 1`` zeros on each side. The difference,
``p0 - (K - 1)`` before and ``p1 + up - 1 - (K - 1)`` after (negative
crops), becomes the padding of the FIR that follows, so no padded copy of
the activation is made.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from viscoin_tpu_torch.ops.upfirdn2d import _filter_size, parse_padding, upfirdn2d
from viscoin_tpu_torch.parallel import spatial


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1, padding=0,
           groups: int = 1, flip_weight: bool = True) -> torch.Tensor:
    """Plain NCHW/OIHW convolution (correlation unless flip_weight=False).

    ``padding`` is an int or ``((py0, py1), (px0, px1))``; negative crops."""
    if not flip_weight:
        w = w.flip([2, 3])
    w = w.to(x.dtype)
    if isinstance(padding, int):
        padding = ((padding, padding), (padding, padding))
    (py0, py1), (px0, px1) = padding
    if py0 == py1 >= 0 and px0 == px1 >= 0:
        return F.conv2d(x, w, stride=stride, padding=(py0, px0), groups=groups)
    x = F.pad(x, [px0, px1, py0, py1])  # negative values crop
    return F.conv2d(x, w, stride=stride, groups=groups)


def _transpose_weight(w: torch.Tensor, groups: int) -> torch.Tensor:
    """OIHW (Co, Ci/g, kh, kw) -> the conv_transpose2d layout (Ci, Co/g, kh, kw)."""
    co, ci_g, kh, kw = w.shape
    w = w.reshape(groups, co // groups, ci_g, kh, kw).transpose(1, 2)
    return w.reshape(groups * ci_g, co // groups, kh, kw)


def conv2d_resample(x: torch.Tensor, w: torch.Tensor, *, f=None, up: int = 1,
                    down: int = 1, padding=0, groups: int = 1,
                    flip_weight: bool = True, flip_filter: bool = False,
                    sp=None) -> torch.Tensor:
    """Conv2d with optional up/downsampling through a FIR filter.

    Args:
        x: (B, C, H, W) input.
        w: (Co, Ci // groups, kh, kw) weights.
        f: resampling FIR filter from :func:`setup_filter` (1-D taps or 2-D),
            used when up > 1 or down > 1.
        up / down: integer resampling factors.
        padding: base conv padding (int or (x0, x1, y0, y1)).
        flip_weight: True = correlation (torch conv2d), False = convolution.
        flip_filter: passed through to upfirdn2d.
        sp: a ``parallel.spatial.Spatial`` when ``x`` is this rank's rows of
            an H-sharded plane: the rows the window reads from the
            neighbours are exchanged first and the padding along H becomes
            the rank's own (``spatial.window``; the up path's transposed
            conv and FIR, and the down path's FIR and strided conv, read as
            one window of kh + fh - 1 rows, so the FIR's local padding may
            be negative, a crop; down needs an even count of rows per rank,
            so that the stride lands on the global rows).
    """
    fh, fw = _filter_size(f)
    px0, px1, py0, py1 = parse_padding(padding)
    kh, kw = w.shape[2], w.shape[3]

    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
        if down > 1:  # the down halo stays in the pre-pad, as in JAX
            px0 += (fw - down + 1) // 2
            px1 += (fw - down) // 2
            py0 += (fh - down + 1) // 2
            py1 += (fh - down) // 2
    elif down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    if sp is not None:
        if up > 1 and down > 1:
            raise NotImplementedError("a conv that both up- and downsamples on H-sharded rows")
        # The FIR and the conv read one window along H (kh + fh - 1 rows).
        k = kh + fh - 1 if up > 1 or down > 1 else kh
        height = x.shape[2] * sp.model
        if (height * up + py0 + py1 - k) // down + 1 != height * up // down \
                or (x.shape[2] * up) % down:
            raise ValueError(f"conv2d_resample on H-sharded rows needs H * up / down output "
                             f"rows and a rank's rows divisible by down; H {height}, rows "
                             f"{x.shape[2]}, up {up}, down {down}")
        top, bottom, py0, py1 = spatial.window(k, up, down, py0)
        x = spatial.halo_exchange(x, top, bottom, sp)

    if up > 1:
        wt = w if not flip_weight else w.flip([2, 3])  # conv_transpose2d convolves
        x = F.conv_transpose2d(x, _transpose_weight(wt, groups).to(x.dtype),
                               stride=up, groups=groups)
        fir_pad = (px0 - (kw - 1), px1 + up - 1 - (kw - 1),
                   py0 - (kh - 1), py1 + up - 1 - (kh - 1))
        x = upfirdn2d(x, f, padding=fir_pad, gain=up**2, flip_filter=flip_filter)
        if down > 1:
            x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
        return x

    if down > 1:
        x = upfirdn2d(x, f, padding=(px0, px1, py0, py1), flip_filter=flip_filter)
        return conv2d(x, w, stride=down, groups=groups, flip_weight=flip_weight)

    return conv2d(x, w, padding=((py0, py1), (px0, px1)), groups=groups,
                  flip_weight=flip_weight)
