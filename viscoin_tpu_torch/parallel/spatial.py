"""Spatial (H-axis) sharding over the model axis of a 2-D mesh.

The JAX package shards the images' H axis over the ``model`` axis of its
``(data, model)`` mesh and lets GSPMD insert the convolutions' halo
exchanges, gathers and reductions. Here each process holds its rows of every
sharded plane, and this module writes those collectives out:

  * :func:`halo_exchange` gives a rank the rows its neighbours hold that its
    window reads (zeros, or ``-inf`` for a max pool, past the global edges);
    its backward is its adjoint, which sends the halo's gradients back to
    their owners, and the two are each other's backward, so every order of
    derivative goes through them;
  * :func:`scatter_rows` (replicated -> this rank's rows) and
    :func:`gather_rows` (rows -> the whole plane on every rank);
  * :func:`model_sum`, the reduction of partial sums over the model group
    (a spatial mean, the pooling to Phi's 3x3, a pixel loss);
    :func:`model_sum` and :func:`gather_rows` are ``parallel/mesh.py``'s
    ``all_sum`` and ``all_gather_batch`` on the model axis;
  * :func:`at` and :func:`convert`, an op's ``sp`` and a value's move
    between two planes' layouts, which are no-ops without a 2-D mesh, so one
    forward serves both;
  * :func:`window`, the halo and the local padding of a sliding-window op
    (up, pad, k taps, down) on a rank's rows, which the sharded ops in
    ``ops/conv2d_resample.py``, ``ops/upfirdn2d.py`` and here
    (:func:`conv2d`, :func:`max_pool2d`) share;
  * :func:`shard_plan`, which planes of a geometry are sharded.

Every collective is one ``all_reduce`` over the model group, which NCCL and
gloo both take for CUDA tensors: a halo exchange reduces a zero-filled slot
buffer of (model, 2, B, C, halo, W) in which each rank fills its own two
slots (its first rows for the rank above, its last rows for the rank below)
and reads its neighbours'. :func:`counts` tallies the calls and the bytes
reduced.

**The gradient rule.** Every value computed from a sharded plane that the
loss reads as a whole (the logits of f, Phi and Phi', LPIPS, the pixel
terms) is made whole on every rank of the model group by :func:`model_sum`,
so every loss term, and the total, is the same on every rank of a model
group. Each collective's backward is its adjoint for the sum of the ranks'
losses (:func:`model_sum`'s is :func:`model_sum`, :func:`scatter_rows`'s
puts the gradient back in its rows with zeros elsewhere, :func:`gather_rows`'s
sums over the group and keeps this rank's rows). A rank's gradient of a
weight is then its part of the gradient of ``model`` times the loss: the
gradient of the global loss is the mean over the model group, and with the
data axis, the mean over all ``data * model`` ranks, which is the one
``all_reduce_grads`` over the whole mesh the data-parallel step already
takes. A weight used on sharded planes (a ``bias_act`` bias, a style, a conv
of Psi) holds a partial gradient per rank before that mean; a weight used
only on replicated values holds the whole one on every rank. Summing over the
model group instead of averaging would count every term ``model`` times;
averaging over the data axis alone would leave the ranks of a model group
with different partial gradients.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from viscoin_tpu_torch.parallel import mesh as M
from viscoin_tpu_torch.parallel.mesh import Mesh

_KINDS = ("halo", "halo_bytes", "gather", "gather_bytes", "scatter", "sum", "sum_bytes")


def reset_counts() -> None:
    M.reset_collective_counts()


def counts() -> dict[str, int]:
    """Calls and bytes since :func:`reset_counts`: halo exchanges (forward
    and adjoint), gathers (their backwards count as sums), scatters (no
    bytes: each rank slices what it holds) and model-group sums, by this
    process."""
    tally = M.collective_counts()
    return {k: tally[k] for k in _KINDS}


@dataclass(eq=False)
class Spatial:
    """The model axis of a 2-D mesh (``axis``: rank = model index, world =
    model ranks) and the :func:`shard_plan` of one geometry."""

    axis: Mesh
    plan: dict[str, bool] = field(default_factory=dict)

    @property
    def model(self) -> int:
        return self.axis.world

    def rows(self, height: int) -> slice:
        """This rank's rows of a plane of ``height`` rows."""
        if height % self.model:
            raise ValueError(f"a plane of {height} rows does not divide over {self.model} "
                             "model ranks")
        h = height // self.model
        return slice(self.axis.rank * h, (self.axis.rank + 1) * h)


# ------------------------------ collectives ------------------------------- #


def _exchange(x: torch.Tensor, top: int, bottom: int, axis: Mesh, fill: float) -> torch.Tensor:
    B, C, h, W = x.shape
    if top > h or bottom > h:
        raise ValueError(f"a halo of ({top}, {bottom}) rows exceeds the {h} rows a rank holds")
    r, n = axis.rank, axis.world
    slots = x.new_zeros((n, 2, B, C, max(top, bottom), W))
    slots[r, 0, :, :, :bottom] = x[:, :, :bottom]  # the rank above's bottom halo
    slots[r, 1, :, :, :top] = x[:, :, h - top:]  # the rank below's top halo
    M.all_reduce_(slots, axis, "halo")
    above = slots[r - 1, 1, :, :, :top] if r > 0 else x.new_full((B, C, top, W), fill)
    below = slots[r + 1, 0, :, :, :bottom] if r < n - 1 else x.new_full((B, C, bottom, W), fill)
    return torch.cat([above, x, below], dim=2)


def _exchange_adjoint(g: torch.Tensor, top: int, bottom: int, axis: Mesh) -> torch.Tensor:
    B, C, ext, W = g.shape
    h = ext - top - bottom
    r, n = axis.rank, axis.world
    slots = g.new_zeros((n, 2, B, C, max(top, bottom), W))
    slots[r, 0, :, :, :top] = g[:, :, :top]  # the rank above's last rows
    slots[r, 1, :, :, :bottom] = g[:, :, top + h:]  # the rank below's first rows
    M.all_reduce_(slots, axis, "halo")
    out = g[:, :, top: top + h].clone()
    if r < n - 1:
        out[:, :, h - top:] += slots[r + 1, 0, :, :, :top]
    if r > 0:
        out[:, :, :bottom] += slots[r - 1, 1, :, :, :bottom]
    return out


class _Halo(torch.autograd.Function):
    """(B, C, h, W) -> (B, C, top + h + bottom, W); backward: the adjoint."""

    @staticmethod
    def forward(ctx, x, top, bottom, axis, fill):
        ctx.args = (top, bottom, axis)
        return _exchange(x, top, bottom, axis, fill)

    @staticmethod
    def backward(ctx, g):
        return _HaloAdjoint.apply(g, *ctx.args), None, None, None, None


class _HaloAdjoint(torch.autograd.Function):
    """The adjoint of :class:`_Halo`; backward: the exchange (zero fill)."""

    @staticmethod
    def forward(ctx, g, top, bottom, axis):
        ctx.args = (top, bottom, axis)
        return _exchange_adjoint(g, top, bottom, axis)

    @staticmethod
    def backward(ctx, gg):
        return _Halo.apply(gg, *ctx.args, 0.0), None, None, None


def halo_exchange(x: torch.Tensor, top: int, bottom: int, sp: Spatial,
                  fill: float = 0.0) -> torch.Tensor:
    """This rank's rows of an H-sharded NCHW plane with ``top`` rows of the
    rank above before them and ``bottom`` rows of the rank below after them
    (``fill`` past the plane's first and last rows), differentiably."""
    if top == 0 and bottom == 0:
        return x
    return _Halo.apply(x, top, bottom, sp.axis, fill)


def model_sum(x: torch.Tensor, sp: Spatial) -> torch.Tensor:
    """The sum of ``x`` over the ranks of the model group, differentiably
    (self-adjoint)."""
    return M.all_sum(x, sp.axis, count=True)


def gather_rows(x: torch.Tensor, sp: Spatial) -> torch.Tensor:
    """The whole plane from every rank's rows of it, on every rank,
    differentiably (backward: the gradient summed over the group, this
    rank's rows)."""
    return M.all_gather_batch(x, sp.axis, dim=2, count=True)


def scatter_rows(x: torch.Tensor, sp: Spatial) -> torch.Tensor:
    """This rank's rows of a plane every rank holds whole (no collective;
    the backward puts the gradient in those rows, zeros elsewhere)."""
    M.count_collective("scatter")
    return x[:, :, sp.rows(x.shape[2])]


def sharded(sp: Spatial | None, plane: str | None) -> bool:
    """Whether ``plane`` of ``sp``'s plan is H-sharded (never without ``sp``;
    ``plane`` None: a value every rank holds whole)."""
    return sp is not None and plane is not None and sp.plan[plane]


def at(sp: Spatial | None, plane: str | None) -> Spatial | None:
    """``sp`` where ``plane`` is sharded, else None: what an op that reads
    the plane takes (None: the op runs on the whole plane, as without a
    mesh)."""
    return sp if sharded(sp, plane) else None


def convert(x: torch.Tensor, sp: Spatial | None, src: str | None, dst: str | None
            ) -> torch.Tensor:
    """``x`` from plane ``src``'s layout to plane ``dst``'s (None: whole):
    this rank's rows or the whole plane. ``x`` itself without ``sp``."""
    a, b = sharded(sp, src), sharded(sp, dst)
    if a == b:
        return x
    return scatter_rows(x, sp) if b else gather_rows(x, sp)


# ------------------------------ the windows ------------------------------- #


def window(k: int, up: int = 1, down: int = 1, pad0: int = 0) -> tuple[int, int, int, int]:
    """The rows a rank needs from its neighbours, and its own padding, for a
    sliding-window op along H: zero-insert ``up``, pad ``pad0`` before, a
    window of ``k`` rows, keep every ``down``-th output; the op is assumed to
    map H rows to ``H * up / down`` (as every op sharded here does).

    Returns (top, bottom, pad0_local, pad1_local): with ``top`` rows of the
    rank above and ``bottom`` of the rank below around its h rows, the same
    op with the padding (pad0_local, pad1_local) (<= 0: crops) computes
    exactly this rank's ``h * up / down`` output rows. The global edges
    take ``top``/``bottom`` rows of the op's padding value instead."""
    top = max(0, -(-pad0 // up))
    bottom = max(0, -(-(k - down - pad0) // up))
    return top, bottom, pad0 - up * top, k - down - pad0 - up * bottom


def _check_rate(h: int, up: int, down: int) -> None:
    if (h * up) % down:
        raise ValueError(f"a rank's {h} rows x up {up} do not divide by down {down}")


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
           stride: int = 1, padding: int = 0, sp: Spatial | None = None) -> torch.Tensor:
    """``F.conv2d`` with a square kernel, stride and symmetric zero padding,
    on this rank's rows of an H-sharded plane (``sp``; without, the whole
    plane): the halo exchange, then the conv padded along W only."""
    if sp is None:
        return F.conv2d(x, weight, bias, stride=stride, padding=padding)
    k = weight.shape[2]
    _check_rate(x.shape[2], 1, stride)
    top, bottom, _, crop = window(k, 1, stride, padding)
    x = halo_exchange(x, top, bottom, sp)
    if crop:
        x = x[:, :, :crop]
    return F.conv2d(x, weight, bias, stride=stride, padding=(0, padding))


def max_pool2d(x: torch.Tensor, k: int, stride: int, padding: int = 0,
               sp: Spatial | None = None) -> torch.Tensor:
    """``F.max_pool2d`` (its padding counts as -inf) on this rank's rows."""
    if sp is None:
        return F.max_pool2d(x, k, stride=stride, padding=padding)
    _check_rate(x.shape[2], 1, stride)
    top, bottom, _, crop = window(k, 1, stride, padding)
    x = halo_exchange(x, top, bottom, sp, fill=float("-inf"))
    if crop:
        x = x[:, :, :crop]
    if padding:
        x = F.pad(x, (padding, padding, 0, 0), value=float("-inf"))
    return F.max_pool2d(x, k, stride=stride)


def mean_hw(x: torch.Tensor, sp: Spatial | None) -> torch.Tensor:
    """(B, C, H, W) -> (B, C): the mean over the whole plane."""
    if sp is None:
        return x.mean(dim=(2, 3))
    return model_sum(x.sum(dim=(2, 3)), sp) / (x.shape[2] * sp.model * x.shape[3])


# -------------------------------- the plan -------------------------------- #

# The (k, up, down, pad0) windows along H of the ops that read each plane.
_STEM, _MAXPOOL = (7, 1, 2, 3), (3, 1, 2, 1)
_1X1, _1X1_2, _3X3, _3X3_2 = (1, 1, 1, 0), (1, 1, 2, 0), (3, 1, 1, 1), (3, 1, 2, 1)
_PSI_CONV1 = (5, 1, 4, 2)
# G: conv0's transposed 3x3 and 4-tap FIR as one window (k = 3 + 4 - 1,
# pad0 = 1 + (4 + 2 - 1) // 2, ops/conv2d_resample.py), the skip upsample.
_UPCONV, _UPSAMPLE = (6, 2, 1, 3), (4, 2, 1, 2)
# D: conv1's 4-tap FIR and stride-2 3x3 as one window (k = 4 + 3 - 1, pad0 =
# 1 + (4 - 2 + 1) // 2), the skip's FIR and stride-2 1x1 (k = 4, pad0 = 1).
_DOWNCONV, _DOWNSKIP = (6, 1, 2, 2), (4, 1, 2, 1)
_VGG_POOL = (2, 1, 2, 0)
RESNET_STAGES = 4
LPIPS_SLICES = 5


def qualifies(height: int, model: int, reads) -> bool:
    """A plane of ``height`` rows can be H-sharded over ``model`` ranks for
    the ops ``reads`` ((k, up, down, pad0) each): its rows divide, each
    rank holds at least the halo of every op, and every op's stride divides
    a rank's rows."""
    if height % model:
        return False
    h = height // model
    for k, up, down, pad0 in reads:
        top, bottom, _, _ = window(k, up, down, pad0)
        if max(top, bottom) > h or (h * up) % down:
            return False
    return True


def shard_plan(image_size: int, model: int, synthesis_resolution: int | None = None,
               resnet_depths=(3, 4, 6, 3)) -> dict[str, bool]:
    """Which planes of the VisCoIN path are H-sharded over ``model`` ranks
    at ``image_size``² (the synthesis at ``synthesis_resolution``², the
    image size unless ``low_res256``): a plane is sharded when it
    :func:`qualifies` for every op that reads it; f's and LPIPS's planes
    shrink, so once one is whole the smaller ones are too (its producer's
    output is gathered); G's grow, so a whole plane is computed on every
    rank and scattered at the first plane that qualifies.

    Planes: "image" (the batch, read by f's stem and LPIPS's first conv),
    "f.stem", "f.pool", "f.stage0".."f.stage3" (f's hidden states),
    "psi.latent" (Psi's conv1-conv5 outputs), "g.<res>" (G's planes at
    each resolution), "lpips.0".."lpips.4" (the VGG slices) and "d.<res>"
    (the discriminator's planes at ``image_size``: a block's input at each
    resolution down to 8², then the epilogue's 4²; they shrink like f's)."""
    plan = {"image": qualifies(image_size, model, [_STEM, _3X3])}
    s = image_size // 2
    plan["f.stem"] = plan["image"] and qualifies(s, model, [_MAXPOOL])
    s //= 2
    plan["f.pool"] = plan["f.stem"] and qualifies(s, model, [_1X1, _3X3])
    prev = plan["f.pool"]
    for i in range(RESNET_STAGES):
        reads = [_1X1, _3X3] if resnet_depths[i] > 1 else []
        if i + 1 < RESNET_STAGES:
            reads += [_1X1_2, _3X3_2]
        reads += {1: [_PSI_CONV1], 2: [_3X3_2], 3: [_3X3]}.get(i, [])
        prev = plan[f"f.stage{i}"] = prev and qualifies(s, model, reads)
        if i + 1 < RESNET_STAGES:
            s //= 2
    plan["psi.latent"] = qualifies(s, model, [_3X3, _1X1])
    res, top = 4, synthesis_resolution or image_size
    while res <= top:
        reads = [_3X3, _1X1] + ([_UPCONV, _UPSAMPLE] if res < top else [])
        plan[f"g.{res}"] = qualifies(res, model, reads)
        if res > 4 and plan[f"g.{res // 2}"] and not plan[f"g.{res}"]:
            raise ValueError(f"G's {res}² plane cannot be sharded over {model} ranks where "
                             f"its {res // 2}² plane is")
        res *= 2
    prev, s = True, image_size
    for i in range(LPIPS_SLICES):
        reads = [_3X3] + ([_VGG_POOL] if i + 1 < LPIPS_SLICES else [])
        prev = plan[f"lpips.{i}"] = prev and qualifies(s, model, reads)
        s //= 2
    prev, res = True, image_size
    while res > 4:
        reads = ([_1X1] if res == image_size else []) + [_3X3, _DOWNCONV, _DOWNSKIP]
        prev = plan[f"d.{res}"] = prev and qualifies(res, model, reads)
        res //= 2
    plan["d.4"] = prev and qualifies(4, model, [_3X3])
    return plan


def spatial_for(mesh, image_size: int, synthesis_resolution: int | None = None,
                resnet_depths=(3, 4, 6, 3)) -> Spatial | None:
    """The :class:`Spatial` of a 2-D ``mesh`` (None for no mesh or a 1-D
    one) at a geometry; raises where the images themselves cannot be
    sharded (the synthesis's last plane is the image)."""
    axis = getattr(mesh, "model_axis", None)
    if axis is None:
        return None
    plan = shard_plan(image_size, axis.world, synthesis_resolution, resnet_depths)
    last = f"g.{synthesis_resolution or image_size}"
    if not (plan["image"] and plan[last] and plan["lpips.0"]):
        raise ValueError(f"{image_size}² images cannot be H-sharded over {axis.world} model "
                         "ranks (each rank needs at least 3 rows and an even count)")
    return Spatial(axis=axis, plan=plan)


def gan_spatial(mesh, image_size: int) -> Spatial | None:
    """The :class:`Spatial` of ``train gan`` on a 2-D ``mesh`` (None for no
    mesh or a 1-D one) at ``image_size``²: G's planes and D's; raises where
    the images cannot be sharded (G's last plane and D's first)."""
    axis = getattr(mesh, "model_axis", None)
    if axis is None:
        return None
    plan = shard_plan(image_size, axis.world)
    if not (plan[f"g.{image_size}"] and plan[f"d.{image_size}"]):
        raise ValueError(f"{image_size}² images cannot be H-sharded over {axis.world} model "
                         "ranks (each rank needs at least 2 rows and an even count)")
    return Spatial(axis=axis, plan=plan)


def bundle_spatial(models, mesh, image_size: int) -> Spatial | None:
    """:func:`spatial_for` at a VisCoIN bundle's geometry (its synthesis
    resolution and f's depths) for ``image_size``² images."""
    if getattr(mesh, "model_axis", None) is None:
        return None
    return spatial_for(mesh, image_size, models.gan.synthesis.img_resolution,
                       models.classifier.config["depths"])
