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

The op is one ``torch.autograd.Function`` whose backward is its adjoint, an
upfirdn2d of the gradient with up and down swapped, the filter flipped and
the padding of :func:`adjoint_padding` (the rule of NVlabs'
``Upfirdn2dCuda.backward``), through the same Function: the kernel on the
card, every order of derivative, since the op is linear. The filter gets
no gradient (it is a module constant).

:func:`setup_filter` returns 1-D normalized taps for a 1-D input (the
StyleGAN ``[1, 3, 3, 1]``), so the generator's resampling always reaches the
kernel. Keep filters as host values (tuples, lists, CPU tensors): the kernel
wrapper reads the taps on the host.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

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
    return _Upfirdn2d.apply(x, f, up, down, padding, flip_filter, gain)


class _Upfirdn2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, f, up, down, padding, flip_filter, gain):
        ctx.args = (f, up, down, padding, flip_filter, gain)
        ctx.x_shape = x.shape
        separable = f is not None and torch.as_tensor(f).ndim == 1
        if separable and x.device.type != "cpu":
            return _upfirdn2d_cuda(x, f, up=up, down=down, padding=padding,
                                   flip_filter=flip_filter, gain=gain)
        return upfirdn2d_plain(x, f, up=up, down=down, padding=padding,
                               flip_filter=flip_filter, gain=gain)

    @staticmethod
    def backward(ctx, dy):
        f, up, down, padding, flip_filter, gain = ctx.args
        dx = None
        if ctx.needs_input_grad[0]:
            p = adjoint_padding(ctx.x_shape, dy.shape, f, up=up, down=down, padding=padding)
            dx = _Upfirdn2d.apply(dy, f, down, up, p, not flip_filter, gain)
        return dx, None, None, None, None, None, None


def adjoint_padding(x_shape, y_shape, f, *, up=1, down=1, padding=0) -> tuple[int, int, int, int]:
    """The padding of the adjoint of ``upfirdn2d(x, f, up, down, padding)``
    (x of ``x_shape``, output of ``y_shape``): the adjoint is upfirdn2d of the
    output gradient with up and down swapped, the filter flipped, the same
    gain, and this padding."""
    upy, upx = _pair(up)
    downy, downx = _pair(down)
    padx0, _, pady0, _ = parse_padding(padding)
    fh, fw = _filter_size(f)
    ih, iw = x_shape[2], x_shape[3]
    oh, ow = y_shape[2], y_shape[3]
    return (fw - padx0 - 1, iw * upx - ow * downx + padx0 - upx + 1,
            fh - pady0 - 1, ih * upy - oh * downy + pady0 - upy + 1)


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


# --------------------------------------------------------------------------- #
# The kernel's launch plan (csrc/upfirdn2d.cu). Everything the kernel's index #
# arithmetic depends on is decided here, where the CPU tests reach it.        #
# --------------------------------------------------------------------------- #

RUN_ROWS = 8                # kRunRows: intermediate rows per thread (sliding pass)
TILE_OUTPUTS = 2048         # outputs per block the tile and planes-per-block aim at
SMEM_LIMIT = 232_448        # shared memory one block may use on Hopper (227 KB)
VARIANTS = {(4, 1, 1): 0, (4, 2, 1): 1, (4, 1, 2): 2}  # (taps, up, down) -> instantiation
RUNTIME_VARIANT = 3         # any other separable filter, pads and factors, per axis


class _FirParams(ctypes.Structure):
    """The kernel's by-value parameter block: ``Plan`` in csrc/upfirdn2d.cu."""

    _fields_ = [("planes", ctypes.c_longlong), ("blocks", ctypes.c_longlong)] + [
        (name, ctypes.c_int) for name in (
            "h", "w", "ho", "wo", "upy", "upx", "downy", "downx", "pady0", "padx0",
            "ky", "kx", "th", "tw", "lg_th", "lg_xruns", "ppb", "lh", "lw", "lwp",
            "xs_floats", "tiles_x", "tiles_y", "smem_bytes", "variant", "is_bf16",
            "vec_store")
    ] + [("ty", ctypes.c_float * MAX_KERNEL_TAPS), ("tx", ctypes.c_float * MAX_KERNEL_TAPS)]


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _pow2_at_most(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round4(n: int) -> int:
    return _ceil_div(n, 4) * 4


@dataclass(frozen=True)
class FirPlan:
    """How one upfirdn2d call is cut into blocks. Axis pairs are (y, x).

    One block computes the output tile ``(th, tw)`` of ``ppb`` planes. Its
    input window along an axis starts at :meth:`window_origin` and spans
    ``lh`` rows / ``lw`` columns; an output's taps start at the phase and
    window offset :meth:`phase` gives. ``taps`` are the correlation taps
    (already flipped for true convolution); the horizontal ones carry the
    gain in the kernel."""

    planes: int
    h: int
    w: int
    ho: int
    wo: int
    up: tuple[int, int]
    down: tuple[int, int]
    pad0: tuple[int, int]
    taps: tuple[float, ...]
    gain: float
    th: int
    tw: int
    vo: int          # outputs per thread along x (16 bytes)
    ppb: int
    lh: int
    lw: int
    lwp: int         # row stride of the intermediate buffer (floats)
    xs_floats: int   # floats of the staged window, a multiple of 4
    tiles_y: int
    tiles_x: int
    blocks: int
    smem_bytes: int
    variant: int
    is_bf16: bool
    vec_store: bool

    @property
    def sliding(self) -> bool:
        """Taps, up and down fixed at compile time and up == 1: the kernel
        slides register windows (8 rows; 16-byte runs of columns)."""
        return self.variant != RUNTIME_VARIANT and self.up == (1, 1)

    @property
    def nv4(self) -> int:
        """float4 loads per horizontal run in the sliding form."""
        return _ceil_div((self.vo - 1) * self.down[1] + len(self.taps), 4)

    def window_origin(self, axis: int, tile: int) -> int:
        """First input row (axis 0) or column (axis 1) a tile reads: the tile's
        first output mapped back through down, pad and up, rounded up to a
        real (not zero-inserted) sample."""
        t = self.th if axis == 0 else self.tw
        return _ceil_div(tile * t * self.down[axis] - self.pad0[axis], self.up[axis])

    def phase(self, axis: int, o: int, origin: int) -> tuple[int, int]:
        """(j0, first): output ``o``'s first tap that meets a real sample and
        the window offset of the sample it meets; taps j0, j0 + up, ... meet
        samples first, first + 1, ..."""
        vb = o * self.down[axis] - self.pad0[axis]
        j0 = (-vb) % self.up[axis]
        return j0, (vb + j0) // self.up[axis] - origin

    @functools.cached_property
    def params_ptr(self) -> int:
        """Address of :attr:`params`, which the plan keeps alive."""
        return ctypes.addressof(self.params)

    @functools.cached_property
    def params(self) -> _FirParams:
        k = len(self.taps)
        taps = np.zeros(MAX_KERNEL_TAPS, np.float32)
        taps[:k] = self.taps
        p = _FirParams(
            planes=self.planes, blocks=self.blocks, h=self.h, w=self.w, ho=self.ho,
            wo=self.wo, upy=self.up[0], upx=self.up[1], downy=self.down[0],
            downx=self.down[1], pady0=self.pad0[0], padx0=self.pad0[1], ky=k, kx=k,
            th=self.th, tw=self.tw, lg_th=self.th.bit_length() - 1,
            lg_xruns=(self.tw // self.vo).bit_length() - 1, ppb=self.ppb, lh=self.lh,
            lw=self.lw, lwp=self.lwp, xs_floats=self.xs_floats, tiles_x=self.tiles_x,
            tiles_y=self.tiles_y, smem_bytes=self.smem_bytes, variant=self.variant,
            is_bf16=int(self.is_bf16), vec_store=int(self.vec_store))
        p.ty[:] = taps.tolist()
        p.tx[:] = (taps * np.float32(self.gain)).tolist()
        return p


def fir_plan(shape: tuple[int, int, int, int], taps: tuple[float, ...], *, up=1, down=1,
             padding=0, flip_filter: bool = False, gain: float = 1.0,
             is_bf16: bool = False) -> FirPlan:
    """Plan the kernel's launch for a (B, C, H, W) input and 1-D ``taps``
    (as given to :func:`upfirdn2d`)."""
    k = len(taps)
    if not 1 <= k <= MAX_KERNEL_TAPS:
        raise ValueError(f"upfirdn2d kernel takes 1 to {MAX_KERNEL_TAPS} taps, got {k}")
    upy, upx = _pair(up)
    downy, downx = _pair(down)
    if min(upy, upx, downy, downx) < 1:
        raise ValueError(f"up and down must be >= 1, got up={up}, down={down}")
    padx0, padx1, pady0, pady1 = parse_padding(padding)
    B, C, H, W = shape
    ho = (H * upy + pady0 + pady1 - k) // downy + 1
    wo = (W * upx + padx0 + padx1 - k) // downx + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"upfirdn2d output would be empty ({ho}x{wo})")
    planes = B * C
    vo = 8 if is_bf16 else 4
    variant = VARIANTS.get((k, upy, downy), RUNTIME_VARIANT) \
        if (upy, downy) == (upx, downx) else RUNTIME_VARIANT
    sliding = variant != RUNTIME_VARIANT and upx == 1
    min_th = RUN_ROWS if sliding else 1
    tw = min(max(_pow2_at_least(wo), vo), max(vo, _pow2_at_most(128 // downx)))
    th = min(max(_pow2_at_least(ho), min_th), max(min_th, _pow2_at_most(32 // downy)))
    while True:
        lh = _ceil_div((th - 1) * downy + k, upy)
        lw = _ceil_div((tw - 1) * downx + k, upx)
        nv4 = _ceil_div((vo - 1) * downx + k, 4)
        lwp = _round4(max(lw, (tw - vo) * downx + 4 * nv4) if sliding else lw)
        fit = (SMEM_LIMIT // 4 - 3) // (lh * lw + th * lwp)
        if fit >= 1:
            break
        if th > min_th:
            th //= 2
        elif tw > vo:
            tw //= 2
        else:
            raise ValueError(f"upfirdn2d kernel: a {k}-tap filter with up={up}, down={down} "
                             f"needs more than {SMEM_LIMIT} bytes of shared memory per block")
    ppb = max(1, min(planes, TILE_OUTPUTS // (th * tw), fit))
    xs_floats = _round4(ppb * lh * lw)
    tiles_y, tiles_x = _ceil_div(ho, th), _ceil_div(wo, tw)
    blocks = _ceil_div(planes, ppb) * tiles_y * tiles_x
    if blocks >= 2**31:
        raise ValueError(f"upfirdn2d kernel: {blocks} blocks exceed the grid")
    t = tuple(float(v) for v in (taps if flip_filter else taps[::-1]))
    return FirPlan(planes=planes, h=H, w=W, ho=ho, wo=wo, up=(upy, upx), down=(downy, downx),
                   pad0=(pady0, padx0), taps=t, gain=float(gain), th=th, tw=tw, vo=vo, ppb=ppb,
                   lh=lh, lw=lw, lwp=lwp, xs_floats=xs_floats, tiles_y=tiles_y,
                   tiles_x=tiles_x, blocks=blocks, smem_bytes=4 * (xs_floats + ppb * th * lwp),
                   variant=variant, is_bf16=is_bf16, vec_store=wo % vo == 0)


def _hashable(v):
    return tuple(v) if isinstance(v, list) else v


_CACHE_SIZE = 512
_taps_cache: dict[int, tuple] = {}  # id(f) -> (f, f._version, taps); holding f pins its id
_plans: dict[tuple, FirPlan] = {}   # the wrapper's arguments -> plan


def _taps(f) -> tuple[float, ...]:
    """The taps of ``f`` as a tuple, read once per filter tensor (the
    generator's filters are module constants)."""
    if not isinstance(f, torch.Tensor):
        return tuple(float(t) for t in np.asarray(f, np.float32).reshape(-1))
    hit = _taps_cache.get(id(f))
    if hit is not None and hit[0] is f and hit[1] == f._version:
        return hit[2]
    taps = tuple(f.reshape(-1).tolist())
    if len(_taps_cache) >= _CACHE_SIZE:
        _taps_cache.clear()
    _taps_cache[id(f)] = (f, f._version, taps)
    return taps


def _upfirdn2d_cuda(x, f, *, up, down, padding, flip_filter, gain):
    if not x.is_cuda:
        raise ValueError(f"upfirdn2d kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"upfirdn2d kernel takes float32 or bfloat16, got {x.dtype}")
    fn = _kernels.entry("upfirdn2d")
    x = x.contiguous()
    key = (x.shape, x.dtype, _taps(f), _hashable(up), _hashable(down), _hashable(padding),
           bool(flip_filter), float(gain))
    plan = _plans.get(key)
    if plan is None:
        if len(_plans) >= _CACHE_SIZE:
            _plans.clear()
        plan = _plans[key] = fir_plan(tuple(x.shape), key[2], up=key[3], down=key[4],
                                      padding=key[5], flip_filter=key[6], gain=key[7],
                                      is_bf16=x.dtype == torch.bfloat16)
    y = torch.empty((x.shape[0], x.shape[1], plan.ho, plan.wo), device=x.device,
                    dtype=x.dtype)
    if y.data_ptr() % 16:
        raise RuntimeError("upfirdn2d kernel: the output allocation is not 16-byte aligned")
    rc = fn(x.data_ptr(), y.data_ptr(), plan.params_ptr, _kernels.current_stream(x))
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
