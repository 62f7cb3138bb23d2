"""Data parallelism over ``torch.distributed``: one process per card.

Counterpart of ``viscoin_tpu/parallel/mesh.py``. The JAX package jits its
steps over a global array, so every reduction in them has global-batch
semantics and GSPMD lays the gradient all-reduce itself. Here each process
holds its slice of the global batch and the collectives below restore the
global semantics explicitly:

  * :func:`all_reduce_grads` averages a list of gradients over the ranks,
    one collective per dtype per call (the trainers call it once per
    optimizer per update, after ``torch.autograd.grad`` or ``backward``);
  * :func:`all_mean` and :func:`all_gather_batch` are differentiable: their
    backwards are collectives too, and are differentiable again (R1 and the
    path length take a second order through them). They serve the
    statistics that span the global batch: BatchNorm's, the discriminator's
    minibatch stddev, the path-length mean;
  * :func:`broadcast_tree`, :func:`barrier`, :func:`is_main`.

The model-group collectives of ``parallel/spatial.py`` are these same
functions on a :class:`Mesh2D`'s :attr:`~Mesh2D.model_axis`, counted
(``count=True``; :func:`collective_counts`).

``DistributedDataParallel`` is not used: the trainers take gradients with
``torch.autograd.grad`` against parameter dicts through
``torch.func.functional_call``, where its reducer hooks never fire, and
differentiate twice. Every collective is an ``all_reduce`` (or a
``broadcast``), which NCCL and gloo both take for CUDA tensors. A failing
collective raises; nothing here falls back to one process.

A process joins a group as ``torchrun`` describes it (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), with a
60 s timeout so that a broken rendezvous or a rank that never arrives fails
instead of hanging.

:func:`make_mesh_2d` arranges the same group as a 2-D ``(data, model)`` mesh
(:class:`Mesh2D`), as the JAX package's ``make_mesh_2d`` does: the ``model``
ranks of a data shard are consecutive and split the images' H axis between
them (``parallel/spatial.py``). Its ``rank``, ``world`` and ``group`` are the
whole group's, so :func:`all_reduce_grads`, :func:`all_mean`,
:func:`broadcast_tree` and :func:`barrier` act on every rank; its ``local``
and ``rows`` and its :attr:`~Mesh2D.data_axis` are the data axis's.
"""

from __future__ import annotations

import os
from collections import Counter
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = timedelta(seconds=60)


@dataclass(frozen=True)
class Mesh:
    """This process's place in a 1-D data-parallel group: its ``rank`` of
    ``world`` processes, its ``device`` and the process ``group`` (None:
    the default group)."""

    rank: int
    world: int
    device: torch.device
    group: object = None

    def local(self, global_batch: int) -> int:
        """The rows of a ``global_batch`` that this rank holds."""
        if global_batch % self.world:
            raise ValueError(f"batch {global_batch} does not divide over the mesh's "
                             f"{self.world} ranks")
        return global_batch // self.world

    def rows(self, n_local: int) -> slice:
        """This rank's rows of a global batch of ``n_local`` rows per rank."""
        return slice(self.rank * n_local, (self.rank + 1) * n_local)

    @property
    def data_axis(self) -> "Mesh":
        """The mesh the batch is split over: this one."""
        return self

    @property
    def model_axis(self) -> "Mesh | None":
        """The mesh the images' H axis is split over: none."""
        return None


@dataclass(frozen=True)
class Mesh2D(Mesh):
    """This process's place in a ``data x model`` mesh of ``world`` processes
    (``rank`` = data index * model + model index). ``local`` and ``rows``
    split a global batch over the data axis; :attr:`data_axis` and
    :attr:`model_axis` are the 1-D meshes of this rank's row and column."""

    data: int = 1
    model: int = 1
    data_group: object = None
    model_group: object = None

    def local(self, global_batch: int) -> int:
        return self.data_axis.local(global_batch)

    def rows(self, n_local: int) -> slice:
        return self.data_axis.rows(n_local)

    @property
    def data_axis(self) -> Mesh:
        return Mesh(rank=self.rank // self.model, world=self.data, device=self.device,
                    group=self.data_group)

    @property
    def model_axis(self) -> Mesh:
        return Mesh(rank=self.rank % self.model, world=self.model, device=self.device,
                    group=self.model_group)


def make_mesh(device="cuda", backend: str | None = None) -> Mesh:
    """Join the process group the environment describes (as ``torchrun``
    sets it) and return this process's :class:`Mesh`, whatever the world
    size. ``device`` "cuda" is ``cuda:LOCAL_RANK`` (made the current
    device), with NCCL; "cpu" takes gloo. An explicit ``backend`` overrides
    that (gloo with CUDA tensors runs several ranks on one card, which NCCL
    refuses). Raises when the environment names no group."""
    if "WORLD_SIZE" not in os.environ:
        raise RuntimeError("make_mesh: WORLD_SIZE is not set; start the processes with "
                           "torchrun (or set RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and "
                           "MASTER_PORT)")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                                timeout=TIMEOUT)
    return Mesh(rank=rank, world=world, device=device)


def destroy_mesh(mesh: Mesh | None) -> None:
    """Leave the process group :func:`make_mesh` joined."""
    if mesh is not None and dist.is_initialized():
        dist.destroy_process_group()


def make_mesh_2d(data: int, model: int, device="cuda", backend: str | None = None) -> Mesh2D:
    """Join the group the environment describes (as :func:`make_mesh`) as a
    ``data x model`` mesh: ranks ``d * model .. d * model + model - 1`` are
    data shard d's model group, as JAX's ``reshape(data, model)`` lays the
    devices. Every rank creates every axis group (``dist.new_group`` is
    collective). Refuses a group of another size than ``data * model``."""
    if data < 1 or model < 1:
        raise ValueError(f"a {data}x{model} mesh has no ranks")
    world = int(os.environ.get("WORLD_SIZE", "0"))
    if "WORLD_SIZE" in os.environ and world != data * model:
        raise ValueError(f"need {data * model} devices for a {data}x{model} mesh, have {world}")
    flat = make_mesh(device, backend)
    data_groups = [dist.new_group([d * model + m for d in range(data)]) for m in range(model)]
    model_groups = [dist.new_group(list(range(d * model, (d + 1) * model)))
                    for d in range(data)]
    return Mesh2D(rank=flat.rank, world=flat.world, device=flat.device, data=data, model=model,
                  data_group=data_groups[flat.rank % model],
                  model_group=model_groups[flat.rank // model])


def is_main(mesh: Mesh | None) -> bool:
    """True on the process that logs and writes: rank 0, or without a mesh."""
    return mesh is None or mesh.rank == 0


def barrier(mesh: Mesh | None) -> None:
    """Wait for every rank (no-op without a mesh)."""
    if mesh is None:
        return
    if dist.get_backend(mesh.group) == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)


_COUNTS: Counter = Counter()


def reset_collective_counts() -> None:
    _COUNTS.clear()


def collective_counts() -> Counter:
    """The counted collectives since :func:`reset_collective_counts`, by
    this process: calls and bytes reduced per kind (``<kind>`` and
    ``<kind>_bytes``)."""
    return Counter(_COUNTS)


def count_collective(kind: str, nbytes: int = 0) -> None:
    _COUNTS[kind] += 1
    _COUNTS[f"{kind}_bytes"] += nbytes


def all_reduce_(buf: torch.Tensor, mesh: Mesh, kind: str | None = None) -> torch.Tensor:
    """Sum ``buf`` over the ranks in place (gloo sums bfloat16 in float32,
    rounding once). ``kind``: count the call and its bytes under that name."""
    wide = buf.dtype == torch.bfloat16 and dist.get_backend(mesh.group) == "gloo"
    work = buf.float() if wide else buf
    dist.all_reduce(work, group=mesh.group)
    if kind is not None:
        count_collective(kind, work.numel() * work.element_size())
    if wide:
        buf.copy_(work)
    return buf


def _all_reduce(x: torch.Tensor, mesh: Mesh, kind: str | None = None) -> torch.Tensor:
    """The sum over the ranks, into a fresh contiguous tensor."""
    return all_reduce_(x.detach().clone(memory_format=torch.contiguous_format), mesh, kind)


def _flat_by_dtype(tensors: list[torch.Tensor]):
    groups: dict[torch.dtype, list[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    for idx in groups.values():
        yield idx, torch.cat([tensors[i].reshape(-1) for i in idx])


def _unflatten_into(flat: torch.Tensor, idx: list[int], tensors: list, out: list) -> None:
    offset = 0
    for i in idx:
        n = tensors[i].numel()
        out[i] = flat[offset: offset + n].view_as(tensors[i])
        offset += n


@torch.no_grad()
def all_reduce_grads(grads: list[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """The mean over the ranks of each gradient: flattened into one buffer
    per dtype, one ``all_reduce`` each, divided by the world size, and
    returned as new tensors in ``grads``' order and shapes."""
    out: list = [None] * len(grads)
    for idx, flat in _flat_by_dtype(grads):
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.world)
        _unflatten_into(flat, idx, grads, out)
    return out


@torch.no_grad()
def broadcast_tree(tensors, mesh: Mesh | None) -> None:
    """Overwrite ``tensors`` (a list, or a dict's values) in place with rank
    0's values, one ``broadcast`` per dtype (no-op without a mesh)."""
    if mesh is None:
        return
    tensors = list(tensors.values()) if isinstance(tensors, dict) else list(tensors)
    for idx, flat in _flat_by_dtype([t.detach() for t in tensors]):
        dist.broadcast(flat, src=0, group=mesh.group)
        out: list = [None] * len(tensors)
        _unflatten_into(flat, idx, tensors, out)
        for i in idx:
            tensors[i].detach().copy_(out[i])


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x, on every rank; self-adjoint."""

    @staticmethod
    def forward(ctx, x, mesh, count):
        ctx.mesh, ctx.count = mesh, count
        return _all_reduce(x, mesh, "sum" if count else None)

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.mesh, ctx.count), None, None


class _AllMean(torch.autograd.Function):
    """y = mean over ranks of x, on every rank; self-adjoint."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(x, mesh).div_(mesh.world)

    @staticmethod
    def backward(ctx, g):
        return _AllMean.apply(g, ctx.mesh), None


class _AllGatherBatch(torch.autograd.Function):
    """The ranks' equal slices concatenated along ``dim`` in the group's rank
    order (on a :class:`Mesh2D`, the whole mesh's, not ``rows``' data axis),
    on every rank: this rank's slice placed into zeros, then summed over the
    ranks. The adjoint sums the gradient over the ranks and keeps this
    rank's slice."""

    @staticmethod
    def forward(ctx, x, mesh, dim, count):
        ctx.mesh, ctx.dim, ctx.n, ctx.count = mesh, dim, x.shape[dim], count
        shape = list(x.shape)
        shape[dim] *= mesh.world
        full = x.new_zeros(shape)
        full.narrow(dim, mesh.rank * ctx.n, ctx.n).copy_(x.detach())
        return all_reduce_(full, mesh, "gather" if count else None)

    @staticmethod
    def backward(ctx, g):
        whole = _AllReduceSum.apply(g, ctx.mesh, ctx.count)
        return whole.narrow(ctx.dim, ctx.mesh.rank * ctx.n, ctx.n), None, None, None


def all_mean(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The mean of ``x`` over the ranks, differentiably (``x`` itself
    without a mesh)."""
    return x if mesh is None else _AllMean.apply(x, mesh)


def all_sum(x: torch.Tensor, mesh: Mesh | None, count: bool = False) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiably (``x`` itself without
    a mesh). ``count``: counted as "sum" (:func:`collective_counts`)."""
    return x if mesh is None else _AllReduceSum.apply(x, mesh, count)


def all_gather_batch(x: torch.Tensor, mesh: Mesh | None, dim: int = 0,
                     count: bool = False) -> torch.Tensor:
    """The global batch from every rank's equal slice ``x`` (rank order
    along ``dim``; on a 2-D mesh, over all its ranks), differentiably (``x``
    itself without a mesh). ``count``: counted as "gather", its backward as
    "sum"."""
    return x if mesh is None else _AllGatherBatch.apply(x, mesh, dim, count)


def pad_to_multiple(batch: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Pad the leading dim up to a multiple by repeating the first row;
    returns (padded, real_count)."""
    n = batch.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return batch, n
    return np.concatenate([batch, np.repeat(batch[:1], rem, axis=0)], axis=0), n
