"""A device mesh, and the collectives of the sharded applies.

Counterpart of ``pytorch_geometric_signed_directed_tpu/parallel/mesh.py``.
The JAX package runs its sharded code under ``shard_map`` on a
``jax.sharding.Mesh``.  Here a mesh is a tuple of devices laid out in a
``shape`` with ``axis_names`` (a data x graph mesh is ``shape=(2, 4),
axis_names=("data", "graph")``); the operators shard over a 1-D mesh along
"graph", and ``Mesh.submesh`` gives the 1-D mesh at one index of the other
axes.

A mesh is driven either by one controller, which runs every shard in turn
(``all_gather`` concatenates the shards' row blocks and ``psum`` adds their
values on the controller's device), or by several processes
(parallel/distributed.py, ``init_process_mesh``), each running only its
own shards; the collectives then go through ``torch.distributed``
(``all_gather_into_tensor``, ``all_reduce``).  Every process computes the
same loss from the gathered (replicated) outputs, so the backward of a
gather is the process's own rows of the gradient, and a replicated tensor
that the shards read in an autograd computation is passed through
``shard_input``, which sums its gradient over the processes (JAX's
``shard_map`` transposes its captured operands the same way).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


@dataclass(frozen=True)
class ProcessGroup:
    """The ``torch.distributed`` default group a process mesh runs on:
    this process's ``rank`` of ``world_size``, each running
    ``shards_per_process`` consecutive shards."""

    rank: int
    world_size: int
    shards_per_process: int
    backend: str


@dataclass(frozen=True)
class Mesh:
    """Devices laid out in ``shape`` (row-major) with ``axis_names``;
    shard d of a 1-D mesh runs on ``devices[d]``.  ``process`` is set on a
    mesh that spans processes (parallel.distributed)."""

    devices: Tuple[torch.device, ...]
    shape: Optional[Tuple[int, ...]] = None
    axis_names: Tuple[str, ...] = ("graph",)
    process: Optional[ProcessGroup] = None

    def __post_init__(self):
        shape = (len(self.devices),) if self.shape is None \
            else tuple(int(s) for s in self.shape)
        object.__setattr__(self, "devices", tuple(self.devices))
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if len(shape) != len(self.axis_names):
            raise ValueError(f"shape {shape} and axis_names "
                             f"{self.axis_names} differ in length")
        if int(np.prod(shape)) != len(self.devices) or not self.devices:
            raise ValueError(f"shape {shape} does not hold "
                             f"{len(self.devices)} devices")

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def submesh(self, **index: int) -> "Mesh":
        """The 1-D mesh at ``index`` of every axis but one, e.g.
        ``mesh.submesh(data=1)`` on a ("data", "graph") mesh: the "graph"
        devices of data row 1."""
        if set(index) - set(self.axis_names):
            raise ValueError(f"unknown axes {sorted(index)}; the mesh has "
                             f"{self.axis_names}")
        free = [a for a in self.axis_names if a not in index]
        if len(free) != 1:
            raise ValueError(f"index every axis but one of "
                             f"{self.axis_names}, got {sorted(index)}")
        grid = np.arange(self.size).reshape(self.shape)
        sel = tuple(slice(None) if a not in index else int(index[a])
                    for a in self.axis_names)
        ids = grid[sel].ravel()
        return Mesh(tuple(self.devices[i] for i in ids), axis_names=free)

    def graph_axis(self, axis: str = "graph") -> int:
        """The number of shards along ``axis``; the sharding functions take
        1-D meshes (or meshes whose other axes have size 1)."""
        if axis not in self.axis_names:
            raise ValueError(f"the mesh has no axis {axis!r} "
                             f"({self.axis_names})")
        if self.axis_size(axis) != self.size:
            raise ValueError(
                f"a {self.shape} mesh over {self.axis_names} holds more than "
                f"the {axis!r} axis: shard on mesh.submesh(...) of one index "
                f"of the other axes")
        return self.size

    @property
    def local(self) -> Tuple[int, ...]:
        """The shards this process builds and runs (all of them on a
        controller's mesh)."""
        if self.process is None:
            return tuple(range(self.size))
        s = self.process.shards_per_process
        r = self.process.rank
        return tuple(range(r * s, (r + 1) * s))

    @property
    def local_devices(self) -> Tuple[torch.device, ...]:
        return tuple(self.devices[d] for d in self.local)

    @property
    def controller(self) -> torch.device:
        """Where this process keeps the replicated tensors and the gathered
        results: the device of its first shard."""
        return self.devices[self.local[0]]


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("graph",),
              shape: Optional[Sequence[int]] = None,
              device: DeviceLike = None) -> Mesh:
    """A mesh over the first ``n_devices`` devices, or over
    ``prod(shape)`` of them laid out in ``shape`` (matching
    ``axis_names``).  With one axis name and no shape, the mesh is
    ``(n_devices,)``; more names get size-1 axes after the first, as in
    the JAX package.  On CUDA (``device=None`` means "cuda") the devices
    are the first cards, every card when neither count nor shape is given;
    it raises beyond ``torch.cuda.device_count()``.  On the CPU
    (``device="cpu"``) they are shards of the one host (default 1), as the
    JAX tests run 8 virtual CPU devices."""
    dev = resolve_device(device)
    axis_names = tuple(axis_names)
    if shape is not None:
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} and axis_names {axis_names} "
                             f"differ in length")
        n = int(np.prod(shape))
    else:
        n = n_devices
        if n is None:
            n = torch.cuda.device_count() if dev.type == "cuda" else 1
        n = int(n)
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if not 1 <= n <= count:
            raise ValueError(f"requested {n} cards, have {count}")
        devices = tuple(torch.device("cuda", i) for i in range(n))
    else:
        if n < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n}")
        devices = (dev,) * n
    return Mesh(devices, shape=shape, axis_names=axis_names)


def local_mesh(device: DeviceLike = None) -> Mesh:
    """The one-device mesh: the same sharded code paths on one card."""
    return make_mesh(1, device=device)


class _ProcessAllGather(torch.autograd.Function):
    """The processes' row blocks in rank order.  Every process computes
    the same loss from the result, so the backward is this process's own
    rows of the gradient."""

    @staticmethod
    def forward(ctx, local, rank, world):
        import torch.distributed as dist

        ctx.rank, ctx.rows = rank, local.shape[0]
        out = local.new_empty((world * local.shape[0],) + local.shape[1:])
        dist.all_gather_into_tensor(out, local.contiguous())
        return out

    @staticmethod
    def backward(ctx, g):
        r = ctx.rows
        return g[ctx.rank * r:(ctx.rank + 1) * r], None, None


class _SumOverProcesses(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the
    processes."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_gather(blocks: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The row blocks of the mesh's shards in shard order, on this
    process's controller device: ``blocks`` are this process's shards'
    (every shard's on a controller's mesh), of one shape.
    Differentiable."""
    local = torch.cat([b.to(mesh.controller) for b in blocks])
    if mesh.process is None:
        return local
    return _ProcessAllGather.apply(local, mesh.process.rank,
                                   mesh.process.world_size)


def psum(values: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The sum of the shards' values (this process's ``values``, in shard
    order, then over the processes) on the controller.  Not
    differentiable: the sharded backwards call it."""
    total = values[0].to(mesh.controller)
    for v in values[1:]:
        total = total + v.to(mesh.controller)
    if mesh.process is not None:
        import torch.distributed as dist

        total = total.contiguous().clone()
        dist.all_reduce(total)
    return total


def shard_input(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A replicated tensor as the mesh's shards read it in an autograd
    computation: ``t`` itself on a controller's mesh (autograd adds the
    shards' gradients); on a process mesh, ``t`` whose gradient is summed
    over the processes, each of which holds only its own shards' part."""
    if mesh.process is None or not t.requires_grad:
        return t
    return _SumOverProcesses.apply(t)
