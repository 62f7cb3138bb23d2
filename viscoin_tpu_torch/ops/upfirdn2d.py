"""upfirdn2d over NCHW: zero-insert upsample, pad, 2-D FIR filter, downsample.

Counterpart of ``viscoin_tpu/ops/upfirdn2d.py`` (semantics) and
``viscoin_tpu/ops/upfirdn2d_pallas.py`` (the TPU kernel):

    1. upsample ``x`` by zero insertion: every sample is followed by
       ``up - 1`` zeros (including at the trailing edge), giving ``H * up``;
    2. pad with zeros by ``(pad_x0, pad_x1, pad_y0, pad_y1)``; negative = crop;
    3. convolve with the FIR filter ``f`` (true convolution, i.e. the filter
       is flipped; ``flip_filter=True`` gives correlation), scaled by ``gain``;
    4. keep every ``down``-th sample, starting at 0.

``f`` is either 1-D separable taps (their outer product is the 2-D filter)
or a 2-D filter. Separable taps on a CUDA tensor go to the hand-written
kernel (``csrc/upfirdn2d.cu``); on a CPU tensor to :func:`upfirdn2d_plain`.
A 2-D filter takes the plain path on every device, as the JAX package's
kernel accepts only separable taps. There is no fallback: a CUDA tensor with
separable taps launches the kernel or raises.

:func:`setup_filter` returns 1-D normalized taps for a 1-D input (the
StyleGAN ``[1, 3, 3, 1]``), so the generator's resampling always reaches the
kernel. Keep filters as host values (tuples, lists, CPU tensors): the kernel
wrapper reads the taps on the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from viscoin_tpu_torch.ops import _kernels

MAX_KERNEL_TAPS = 16  # VISCOIN_UPFIRDN_MAX_TAPS in csrc/upfirdn2d.cu


def _pair(v) -> tuple[int, int]:
    if isinstance(v, (tuple, list)):
        if len(v) != 2:
            raise ValueError(f"expected an int or a pair, got {v!r}")
        return int(v[0]), int(v[1])
    return int(v), int(v)


def parse_padding(padding) -> tuple[int, int, int, int]:
    """padding -> (pad_x0, pad_x1, pad_y0, pad_y1), reference convention."""
    if isinstance(padding, int):
        return padding, padding, padding, padding
    padding = list(padding)
    if len(padding) == 2:
        px, py = padding
        return px, px, py, py
    if len(padding) != 4:
        raise ValueError(f"padding must be an int, (x, y) or (x0, x1, y0, y1): {padding!r}")
    return tuple(int(p) for p in padding)


def setup_filter(f, *, normalize: bool = True, flip_filter: bool = False,
                 gain: float = 1.0) -> torch.Tensor:
    """Prepare a FIR filter for upfirdn2d (a float32 CPU tensor).

    ``f`` is a scalar, 1-D taps or a 2-D filter; ``None`` is one tap of 1.
    1-D taps stay separable: normalized to sum to 1, each axis carrying
    ``sqrt(gain)``, so their outer product is the 2-D grid the JAX package's
    ``setup_filter`` returns."""
    if f is None:
        f = 1.0
    f = torch.as_tensor(f, dtype=torch.float32).cpu()
    if f.ndim == 0:
        f = f[None]
    if f.ndim not in (1, 2):
        raise ValueError(f"filter must be 1-D or 2-D, got {f.ndim}-D")
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f.flip(list(range(f.ndim)))
    return f * (gain ** (f.ndim / 2))


def _filter_2d(f) -> torch.Tensor:
    f = torch.ones((1, 1)) if f is None else torch.as_tensor(f, dtype=torch.float32)
    if f.ndim == 0:
        f = f[None]
    return torch.outer(f, f) if f.ndim == 1 else f


def upfirdn2d(x: torch.Tensor, f, *, up=1, down=1, padding=0,
              flip_filter: bool = False, gain: float = 1.0) -> torch.Tensor:
    """Upsample, FIR filter and downsample a batch of NCHW images.

    Args:
        x: (B, C, H, W) input.
        f: 1-D separable taps, a 2-D filter, or ``None`` for identity.
        up, down: integer factors or (y, x) pairs.
        padding: int, (x, y) or (x0, x1, y0, y1), applied after upsampling.
        flip_filter: False = convolution (reference default), True = correlation.
        gain: output scaling.
    """
    if x.ndim != 4:
        raise ValueError(f"expected NCHW input, got shape {tuple(x.shape)}")
    separable = f is not None and torch.as_tensor(f).ndim == 1
    if separable and x.device.type != "cpu":
        return _upfirdn2d_cuda(x, f, up=up, down=down, padding=padding,
                               flip_filter=flip_filter, gain=gain)
    return upfirdn2d_plain(x, f, up=up, down=down, padding=padding,
                           flip_filter=flip_filter, gain=gain)


def upfirdn2d_plain(x, f, *, up=1, down=1, padding=0, flip_filter=False, gain=1.0):
    """The plain torch version: zero-insert by reshape, pad/crop, one
    depthwise ``conv2d`` with the (flipped) 2-D filter, strided slice."""
    upy, upx = _pair(up)
    downy, downx = _pair(down)
    padx0, padx1, pady0, pady1 = parse_padding(padding)
    f = _filter_2d(f).to(device=x.device, dtype=torch.float32)
    B, C, H, W = x.shape

    x = x.reshape(B, C, H, 1, W, 1)
    x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
    x = x.reshape(B, C, H * upy, W * upx)
    x = F.pad(x, [max(padx0, 0), max(padx1, 0), max(pady0, 0), max(pady1, 0)])
    x = x[:, :, max(-pady0, 0): x.shape[2] - max(-pady1, 0),
          max(-padx0, 0): x.shape[3] - max(-padx1, 0)]

    if not flip_filter:  # conv2d correlates; true convolution flips the filter
        f = f.flip([0, 1])
    f = (f * gain).to(x.dtype)
    weight = f[None, None].repeat(C, 1, 1, 1)
    x = F.conv2d(x, weight, groups=C)
    return x[:, :, ::downy, ::downx]


def _upfirdn2d_cuda(x, f, *, up, down, padding, flip_filter, gain):
    if not x.is_cuda:
        raise ValueError(f"upfirdn2d kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"upfirdn2d kernel takes float32 or bfloat16, got {x.dtype}")
    fn = _kernels.entry("upfirdn2d")
    upy, upx = _pair(up)
    downy, downx = _pair(down)
    padx0, padx1, pady0, pady1 = parse_padding(padding)
    taps = np.asarray(torch.as_tensor(f, dtype=torch.float32).cpu(), np.float32).reshape(-1)
    if len(taps) > MAX_KERNEL_TAPS:
        raise ValueError(f"upfirdn2d kernel takes at most {MAX_KERNEL_TAPS} taps, got {len(taps)}")
    if not flip_filter:
        taps = taps[::-1]
    taps = np.ascontiguousarray(taps, np.float32)
    B, C, H, W = x.shape
    ho = (H * upy + pady0 + pady1 - len(taps)) // downy + 1
    wo = (W * upx + padx0 + padx1 - len(taps)) // downx + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"upfirdn2d output would be empty ({ho}x{wo})")
    x = x.contiguous()
    y = torch.empty((B, C, ho, wo), device=x.device, dtype=x.dtype)
    taps_p = taps.ctypes.data_as(_kernels._float_p)
    rc = fn(x.data_ptr(), y.data_ptr(), B * C, H, W, ho, wo,
            taps_p, len(taps), taps_p, len(taps), upy, upx, downy, downx,
            pady0, padx0, float(gain), int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check("upfirdn2d", rc)
    return y


def upsample2d(x, f, *, up=2, padding=0, flip_filter=False, gain=1.0):
    """Upsample with the reference's padding convention; the gain is
    multiplied by ``up**2`` so a normalized filter keeps brightness."""
    upy, upx = _pair(up)
    fh, fw = _filter_size(f)
    px0, px1, py0, py1 = parse_padding(padding)
    p = (px0 + (fw + upx - 1) // 2, px1 + (fw - upx) // 2,
         py0 + (fh + upy - 1) // 2, py1 + (fh - upy) // 2)
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter,
                     gain=gain * upx * upy)


def downsample2d(x, f, *, down=2, padding=0, flip_filter=False, gain=1.0):
    """Downsample with the reference's padding convention."""
    downy, downx = _pair(down)
    fh, fw = _filter_size(f)
    px0, px1, py0, py1 = parse_padding(padding)
    p = (px0 + (fw - downx + 1) // 2, px1 + (fw - downx) // 2,
         py0 + (fh - downy + 1) // 2, py1 + (fh - downy) // 2)
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter, gain=gain)


def _filter_size(f) -> tuple[int, int]:
    """(fh, fw) of a filter in either form (1-D taps: the same on both axes)."""
    if f is None:
        return 1, 1
    shape = torch.as_tensor(f).shape
    if len(shape) == 0:
        return 1, 1
    return (shape[0], shape[0]) if len(shape) == 1 else (shape[0], shape[1])


# --------------------------------------------------------------------------- #
# Slow oracle for tests: direct zero-insert + pad + convolve + slice in numpy #
# (NHWC, a copy of the JAX package's upfirdn2d_ref).                          #
# --------------------------------------------------------------------------- #


def upfirdn2d_ref(x, f, *, up=1, down=1, padding=0, flip_filter=False, gain=1.0):
    """Direct numpy realization of the documented semantics on NHWC input."""
    x = np.asarray(x, np.float64)
    upy, upx = _pair(up)
    downy, downx = _pair(down)
    padx0, padx1, pady0, pady1 = parse_padding(padding)
    if f is None:
        f = np.ones((1, 1))
    f = np.asarray(f, np.float64)
    if f.ndim == 1:
        f = np.outer(f, f)

    B, H, W, C = x.shape
    z = np.zeros((B, H * upy, W * upx, C))
    z[:, ::upy, ::upx, :] = x
    z = np.pad(z, ((0, 0), (max(pady0, 0), max(pady1, 0)), (max(padx0, 0), max(padx1, 0)),
                   (0, 0)))
    z = z[:, max(-pady0, 0): z.shape[1] - max(-pady1, 0),
          max(-padx0, 0): z.shape[2] - max(-padx1, 0), :]
    ff = f if flip_filter else f[::-1, ::-1]
    fh, fw = ff.shape
    Ho = z.shape[1] - fh + 1
    Wo = z.shape[2] - fw + 1
    out = np.zeros((B, Ho, Wo, C))
    for i in range(fh):
        for j in range(fw):
            out += ff[i, j] * z[:, i: i + Ho, j: j + Wo, :]
    out *= gain
    return out[:, ::downy, ::downx, :]
