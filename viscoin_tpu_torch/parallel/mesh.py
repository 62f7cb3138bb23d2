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

``DistributedDataParallel`` is not used: the trainers take gradients with
``torch.autograd.grad`` against parameter dicts through
``torch.func.functional_call``, where its reducer hooks never fire, and
differentiate twice. Every collective is an ``all_reduce`` (or a
``broadcast``), which NCCL and gloo both take for CUDA tensors. A failing
collective raises; nothing here falls back to one process.

A process joins a group as ``torchrun`` describes it (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), with a
60 s timeout so that a broken rendezvous or a rank that never arrives fails
instead of hanging. A model-parallel (2-D) mesh is not ported.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = timedelta(seconds=60)
MODEL_PARALLEL_NOT_PORTED = ("a 2-D (data, model) mesh is not ported yet (ROADMAP.md, "
                             "queue 1: model parallelism, --model-parallel)")


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


def make_mesh_2d(data: int, model: int):
    raise NotImplementedError(MODEL_PARALLEL_NOT_PORTED)


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


def _all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over the ranks, into a fresh contiguous tensor."""
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=mesh.group)
    return y


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
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.mesh), None


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
    """The ranks' equal slices concatenated along dim 0, on every rank: this
    rank's slice placed into zeros, then summed over the ranks. The adjoint
    sums the gradient over the ranks and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[0]
        full = x.new_zeros((mesh.world * x.shape[0], *x.shape[1:]))
        full[mesh.rows(x.shape[0])] = x.detach()
        dist.all_reduce(full, group=mesh.group)
        return full

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.mesh)[ctx.mesh.rows(ctx.n)], None


def all_mean(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The mean of ``x`` over the ranks, differentiably (``x`` itself
    without a mesh)."""
    return x if mesh is None else _AllMean.apply(x, mesh)


def all_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiably (``x`` itself without
    a mesh)."""
    return x if mesh is None else _AllReduceSum.apply(x, mesh)


def all_gather_batch(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The global batch from every rank's equal slice ``x`` (rank order
    along dim 0), differentiably (``x`` itself without a mesh)."""
    return x if mesh is None else _AllGatherBatch.apply(x, mesh)


def pad_to_multiple(batch: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Pad the leading dim up to a multiple by repeating the first row;
    returns (padded, real_count)."""
    n = batch.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return batch, n
    return np.concatenate([batch, np.repeat(batch[:1], rem, axis=0)], axis=0), n
