"""A device mesh as one controller's list of devices, and its collectives.

Counterpart of ``pytorch_geometric_signed_directed_tpu/parallel/mesh.py``.
The JAX package runs its sharded code under ``shard_map`` on a
``jax.sharding.Mesh``; here one process drives every device of the mesh in
turn, so the collectives are plain functions: ``all_gather`` concatenates
the row blocks of the shards, ``psum`` adds their values, both on the
mesh's first device (the controller, where replicated tensors live).
Multi-process ``torch.distributed`` is later work (ROADMAP.md queue A,
item 17).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from ..device import DeviceLike, resolve_device


@dataclass(frozen=True)
class Mesh:
    """The devices of the mesh's one axis (the JAX package's "graph"
    axis), shard d on ``devices[d]``."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None,
              device: DeviceLike = None) -> Mesh:
    """A mesh of ``n_devices`` shards.  On CUDA (``device=None`` means
    "cuda") the first ``n_devices`` cards, every card when None; it raises
    beyond ``torch.cuda.device_count()``.  On the CPU (``device="cpu"``)
    ``n_devices`` shards (default 1) on the one host, as the JAX tests run
    8 virtual CPU devices."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        n = count if n_devices is None else int(n_devices)
        if not 1 <= n <= count:
            raise ValueError(f"requested {n} cards, have {count}")
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)))
    n = 1 if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    return Mesh((dev,) * n)


def local_mesh(device: DeviceLike = None) -> Mesh:
    """The one-device mesh: the same sharded code paths on one card."""
    return make_mesh(1, device=device)


def all_gather(blocks: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The shards' row blocks, in shard order, as one tensor on the
    controller."""
    return torch.cat([b.to(mesh.devices[0]) for b in blocks])


def psum(values: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The sum of the shards' values, in shard order, on the controller."""
    total = values[0].to(mesh.devices[0])
    for v in values[1:]:
        total = total + v.to(mesh.devices[0])
    return total
