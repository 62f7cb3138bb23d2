"""Adaptive discriminator augmentation (ADA): the 'bgc' pipe and the p controller.

Counterpart of ``viscoin_tpu/train/augment.py``, on NCHW images. Every
spatial transform of an image (x-flip, 90-degree rotations, integer
translation, isotropic and anisotropic scaling, rotation, fractional
translation) is composed into one inverse affine map, applied by
:func:`twopass_warp`; every colour transform (brightness, contrast, luma
flip, hue rotation, saturation) into one 4x4 homogeneous colour matrix.
Each transform hits each image independently with probability ``p``.

The random numbers are drawn apart from their use: :func:`draw_augment`
takes them from an explicit ``torch.Generator`` (on the host: they are a
few per image) and :func:`augment` is a pure function of (images, p,
draws), so tests can feed it the numbers JAX's keys give
(:class:`AugmentDraws` holds them in the JAX function's order), and a
resumed run draws the same ones. The per-image maps are composed on the
host in fp32, as JAX composes them on the device; where no image of the
batch is warped (or recoloured), the warp (or the colour product) is not
run, since it would return the images unchanged.

:func:`twopass_warp` samples bilinearly in two passes, each output the
two samples its source position falls between, gathered and weighted
(:func:`_lerp`): what JAX's dense per-line interpolation matrices compute
(about H * W^2 elements per image and pass, 4.3 GB in fp32 at 1024²),
without building them. As JAX does with ``jax.checkpoint``, the warp is
recomputed in the backward (``torch.utils.checkpoint``), and R1's second
order differentiates through the recompute.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

import torch
from torch.utils.checkpoint import checkpoint

from viscoin_tpu_torch.parallel import spatial as S

_MAX_T = 0.125  # integer translation range, a fraction of the size


@dataclass
class AugmentDraws:
    """The raw random numbers of one :func:`augment` call, per image (B,),
    in the order JAX's ``augment`` draws them from ``split(key, 16)`` (the
    colour stage from ``split(keys[15], 10)``). ``*_do`` are uniforms in
    [0, 1) compared with p; the rest are the transforms' own draws."""

    flip_do: torch.Tensor
    flip_coin: torch.Tensor      # uniform: flip where < 0.5
    r90_do: torch.Tensor
    r90_k: torch.Tensor          # integer in {0, 1, 2, 3}
    xint_do: torch.Tensor
    tx: torch.Tensor             # uniform in [-0.125, 0.125)
    ty: torch.Tensor
    iso_do: torch.Tensor
    iso: torch.Tensor            # normal
    rot_do: torch.Tensor
    theta: torch.Tensor          # uniform in [-pi, pi)
    aniso_do: torch.Tensor
    aniso: torch.Tensor          # normal
    frac_do: torch.Tensor
    frac: torch.Tensor           # normal, (B, 2)
    bright_do: torch.Tensor
    bright: torch.Tensor         # normal
    contrast_do: torch.Tensor
    contrast: torch.Tensor       # normal
    lumaflip_do: torch.Tensor
    lumaflip_coin: torch.Tensor  # uniform: reflect where < 0.5
    hue_do: torch.Tensor
    hue: torch.Tensor            # uniform in [-pi, pi)
    sat_do: torch.Tensor
    sat: torch.Tensor            # normal

    def rows(self, index: slice) -> "AugmentDraws":
        """The draws of the images ``index`` selects (a rank's rows of the
        global batch's draws)."""
        return AugmentDraws(**{f.name: getattr(self, f.name)[index] for f in fields(self)})

    @classmethod
    def from_arrays(cls, arrays: dict) -> "AugmentDraws":
        """From a dict of array-likes keyed by field name (fp32; ``r90_k``
        integer)."""
        return cls(**{f.name: torch.tensor(arrays[f.name],
                                           dtype=torch.int64 if f.name == "r90_k"
                                           else torch.float32)
                      for f in fields(cls)})


def draw_augment(batch: int, generator: torch.Generator) -> AugmentDraws:
    """The random numbers of one :func:`augment` call for ``batch`` images,
    from ``generator`` (a CPU generator), in :class:`AugmentDraws`' order."""
    def u(lo=0.0, hi=1.0):
        return torch.rand(batch, generator=generator) * (hi - lo) + lo

    def n(*shape):
        return torch.randn((batch, *shape), generator=generator)

    out = {}
    for f in fields(AugmentDraws):
        name = f.name
        if name.endswith(("_do", "_coin")):
            out[name] = u()
        elif name == "r90_k":
            out[name] = torch.randint(0, 4, (batch,), generator=generator)
        elif name in ("tx", "ty"):
            out[name] = u(-_MAX_T, _MAX_T)
        elif name in ("theta", "hue"):
            out[name] = u(-math.pi, math.pi)
        else:
            out[name] = n(2) if name == "frac" else n()
    return AugmentDraws(**out)


def _lerp(src: torch.Tensor, pos: torch.Tensor, dim: int) -> torch.Tensor:
    """sum over s of hat(s - pos) * src[..., s, ...] along ``dim`` (2 or 3),
    ``pos`` (B, H, W) giving each output's source position (broadcast over
    the channels): the two samples floor(pos) and floor(pos) + 1 with the
    weights 1 - frac and frac, zero outside the plane; what one row of a
    dense interpolation matrix of hat weights computes."""
    n = src.shape[dim]
    p0 = torch.floor(pos)
    frac = pos - p0
    out = None
    for at, weight in ((p0, 1.0 - frac), (p0 + 1.0, frac)):
        inside = (at >= 0) & (at <= n - 1)
        index = at.clamp(0, n - 1).long()[:, None].expand(-1, src.shape[1], -1, -1)
        w = torch.where(inside, weight, 0.0)[:, None].to(src.dtype)
        term = torch.gather(src, dim, index) * w
        out = term if out is None else out + term
    return out


def _warp(images: torch.Tensor, A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    B, C, H, W = images.shape
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    a00, a01 = A[:, 0, 0, None, None], A[:, 0, 1, None, None]
    a10, a11 = A[:, 1, 0, None, None], A[:, 1, 1, None, None]
    vx, vy = v[:, 0, None, None], v[:, 1, None, None]
    det = a00 * a11 - a01 * a10
    xs = torch.arange(W, dtype=torch.float32, device=images.device)
    ys = torch.arange(H, dtype=torch.float32, device=images.device)

    # Pass 1: along y, at the source-y positions on the sheared lines (B, x, Y).
    syp = ((a10 / a00) * (xs[None, :, None] - cx - vx)
           + (det / a00) * (ys[None, None, :] - cy) + cy + vy)
    tmp = _lerp(images, syp.transpose(1, 2), 2)
    # Pass 2: along x, at the exact source-x positions (B, Y, X).
    sx = a00 * (xs[None, None, :] - cx) + a01 * (ys[None, :, None] - cy) + cx + vx
    return _lerp(tmp, sx, 3)


def twopass_warp(images: torch.Tensor, A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Affine bilinear warp in two gathered passes, recomputed in the
    backward.

    Samples ``src = A @ (p - c) + c + v`` per output pixel ``p`` ((x, y)
    coordinates, ``c`` the image centre), zero outside the image. Pass 1
    resamples along y at the original columns on the sheared line, pass 2
    along x at the exact source x: exact when ``A[1, 0] == 0``, otherwise
    the Catmull-Smith two-pass approximation, as in JAX.

    Args:
        images: (B, C, H, W).
        A: (B, 2, 2) inverse maps, rows and columns in (x, y) order (fp32).
        v: (B, 2) translations in pixels, (x, y) order (fp32).
    """
    return checkpoint(_warp, images, A, v, use_reentrant=False)


def _rotation2d(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def _spatial(d: AugmentDraws, p: float, H: int, W: int):
    """The composed inverse maps (A, v), the images that take the final
    exact rot90 (``use_k1``) and those left untouched (``skip``)."""
    f32 = torch.float32
    flip = (d.flip_do < p) & (d.flip_coin < 0.5)
    k_blit = torch.where(d.r90_do < p, d.r90_k, torch.zeros_like(d.r90_k))
    do = d.xint_do < p
    tx = torch.round(d.tx * W)
    ty = torch.round(d.ty * H)
    t_int = torch.stack([torch.where(do, tx, 0.0), torch.where(do, ty, 0.0)], -1)
    s_iso = torch.where(d.iso_do < p, torch.exp2(d.iso * 0.2), 1.0)
    theta = torch.where(d.rot_do < p, d.theta, 0.0)
    s_aniso = torch.where(d.aniso_do < p, torch.exp2(d.aniso * 0.2), 1.0)
    frac = torch.where((d.frac_do < p)[:, None], d.frac * 0.125, 0.0)

    # The inverse source map, stage by stage (geometric^-1, xint^-1,
    # rot90^-1, flip^-1), in centred (x, y) pixel coordinates.
    rot = _rotation2d(theta)
    scale = torch.stack([s_aniso, torch.ones_like(s_aniso)], -1) * s_iso[:, None]
    A = torch.linalg.inv(rot * scale[:, None, :])
    t_pix = frac * torch.tensor([W, H], dtype=f32)
    v = -torch.einsum("bij,bj->bi", A, t_pix)
    v = v - t_int
    r90 = torch.tensor([[0.0, -1.0], [1.0, 0.0]])
    r90_pows = torch.stack([torch.eye(2), r90, r90 @ r90, r90 @ r90 @ r90])
    rb = r90_pows[k_blit]
    A = torch.einsum("bij,bjk->bik", rb, A)
    v = torch.einsum("bij,bj->bi", rb, v)
    fsign = torch.where(flip, -1.0, 1.0)
    fvec = torch.stack([fsign, torch.ones_like(fsign)], -1)
    A = A * fvec[:, :, None]
    v = v * fvec

    # Factor the exact multiple-of-90-degrees part out of A (undone by a
    # rot90 of the output) so that the two-pass shear stays small.
    ratio0 = A[:, 1, 0].abs() / (A[:, 0, 0].abs() + 1e-12)
    ratio1 = A[:, 1, 1].abs() / (A[:, 0, 1].abs() + 1e-12)
    use_k1 = ratio1 < ratio0
    r90_inv = torch.tensor([[0.0, 1.0], [-1.0, 0.0]])
    A = torch.where(use_k1[:, None, None], torch.einsum("bij,jk->bik", A, r90_inv), A)
    skip = (((A - torch.eye(2)).abs().amax(dim=(1, 2)) < 1e-9)
            & (v.abs().amax(dim=1) < 1e-9) & ~use_k1)
    return A, v, use_k1, skip


def _color(d: AugmentDraws, p: float) -> torch.Tensor:
    """The composed (B, 4, 4) colour matrices (the identity, exactly, for an
    image no colour transform hits)."""
    B = d.bright.shape[0]
    eye = torch.eye(4)
    mats = eye.expand(B, 4, 4)

    b_ = torch.where(d.bright_do < p, d.bright * 0.2, 0.0)
    m = eye.repeat(B, 1, 1)
    m[:, :3, 3] = b_[:, None]
    mats = torch.einsum("bij,bjk->bik", m, mats)

    c_ = torch.where(d.contrast_do < p, torch.exp2(d.contrast * 0.5), 1.0)
    m = torch.diag_embed(torch.cat([c_[:, None].expand(B, 3), torch.ones(B, 1)], dim=1))
    mats = torch.einsum("bij,bjk->bik", m, mats)

    v = torch.tensor([1.0, 1.0, 1.0, 0.0]) / math.sqrt(3.0)  # the luma axis
    fl = (d.lumaflip_do < p) & (d.lumaflip_coin < 0.5)
    refl = eye - 2.0 * torch.outer(v, v)
    m = torch.where(fl[:, None, None], refl[None], eye[None])
    mats = torch.einsum("bij,bjk->bik", m, mats)

    ang = torch.where(d.hue_do < p, d.hue, 0.0)
    k = v[:3]
    K = torch.tensor([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    R = (torch.eye(3) + torch.sin(ang)[:, None, None] * K
         + (1 - torch.cos(ang))[:, None, None] * (K @ K))
    m = eye.repeat(B, 1, 1)
    m[:, :3, :3] = R
    mats = torch.einsum("bij,bjk->bik", m, mats)

    do = d.sat_do < p
    s_ = torch.where(do, torch.exp2(d.sat), 1.0)
    vv = torch.outer(v, v)
    m = vv[None] + (eye - vv)[None] * s_[:, None, None]
    # An image the saturation does not hit keeps the exact identity (JAX
    # composes vv + (I - vv) * 1, the identity up to rounding).
    m = torch.where(do[:, None, None], m, eye[None])
    return torch.einsum("bij,bjk->bik", m, mats)


def augment(images: torch.Tensor, p: float, draws: AugmentDraws,
            sp: S.Spatial | None = None) -> torch.Tensor:
    """Apply the ADA 'bgc' pipe to a batch.

    Args:
        images: (B, C, H, W) float images in [-1, 1], square.
        p: the augmentation probability.
        draws: the batch's random numbers (:func:`draw_augment`).
        sp: a ``parallel.spatial.Spatial`` when ``images`` are this rank's
            rows of the batch (the draws the same on every rank of the
            model group): the warp moves pixels across the ranks' rows (pass
            1 along y, the rot90 turning columns into rows), so the rows
            are gathered, the whole images warped and this rank's rows kept;
            the colour matrices act per pixel, on the rows. Nothing is
            gathered where no image is warped.
    """
    B, C, h, W = images.shape
    H = h if sp is None else h * sp.model
    if H != W:
        # The rot90 stages are area-preserving only on square images.
        raise ValueError(f"augment() requires square images, got {H}x{W}")
    p = float(p)
    A, v, use_k1, skip = _spatial(draws, p, H, W)
    x = images
    if not bool(skip.all()):
        dev = images.device
        whole = x if sp is None else S.gather_rows(x, sp)
        warped = twopass_warp(whole, A.to(dev), v.to(dev))
        warped = torch.where(use_k1.to(dev)[:, None, None, None],
                             torch.rot90(warped, 1, dims=(2, 3)), warped)
        if sp is not None:
            warped = S.scatter_rows(warped, sp)
        x = torch.where(skip.to(dev)[:, None, None, None], x, warped)

    mats = _color(draws, p)
    if bool((mats == torch.eye(4)).all()):
        return x
    # Composed in fp32; applied in the image dtype (bf16 under mixed precision).
    mats = mats.to(device=x.device, dtype=x.dtype)
    xh = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)  # (B, 4, H, W)
    return torch.einsum("bjhw,bij->bihw", xh, mats)[:, :3]


def ada_update(ada_p: torch.Tensor, rt_acc: torch.Tensor, rt_batch: torch.Tensor, step: int,
               batch_size: int, target: float = 0.6, interval: int = 4,
               kimg: float = 500.0) -> tuple[torch.Tensor, torch.Tensor]:
    """The adaptive-p controller: accumulate ``rt_batch`` = E[sign(D(real))]
    and, every ``interval`` steps (after step ``step``), move p by
    +-(batch * interval) / (kimg * 1000) toward r_t == target, clamped to
    [0, 1]. ``ada_p`` (fp32, 0-d) may live on the host and the r_t
    accumulator on the card: they meet (one copy) only on adjusting steps.

    Returns (new_ada_p, new_rt_acc)."""
    rt_acc = rt_acc + rt_batch
    if (step + 1) % interval != 0:
        return ada_p, rt_acc
    rt = (rt_acc / interval).to(ada_p.device)
    adjust = torch.sign(rt - target) * ((batch_size * interval) / (kimg * 1000.0))
    return torch.clamp(ada_p + adjust, 0.0, 1.0), torch.zeros_like(rt_acc)
