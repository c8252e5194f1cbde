"""A mesh that spans processes, through ``torch.distributed``.

Counterpart of ``jax.distributed.initialize`` as
``scripts/dryrun_multiprocess.py`` calls it.  Each process joins the
default process group and runs ``shards_per_process`` consecutive shards
of one "graph" axis: shard d belongs to process ``d // shards_per_process``.
The sharding functions then build only this process's shards, and
parallel/mesh.py's collectives go through ``torch.distributed``.  Run one
process per card (NCCL refuses two ranks on one card); on the CPU, gloo.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from ..device import DeviceLike, resolve_device
from .mesh import Mesh, ProcessGroup

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_process_mesh(shards_per_process: int,
                      backend: Optional[str] = None,
                      device: DeviceLike = None) -> Mesh:
    """Join the process group named by ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` (once per process) and return the
    1-D "graph" mesh of ``WORLD_SIZE * shards_per_process`` shards.  The
    backend is NCCL on CUDA (``device=None`` means "cuda"; the process's
    card is ``LOCAL_RANK``, else ``RANK``, modulo the card count) and gloo
    on the CPU.  A failed join raises."""
    import torch.distributed as dist

    dev = resolve_device(device)
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"init_process_mesh needs {', '.join(missing)} "
                           f"in the environment")
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    if shards_per_process < 1:
        raise ValueError(f"shards_per_process={shards_per_process} must be "
                         f"positive")
    if not 0 <= rank < world:
        raise ValueError(f"RANK={rank} is outside WORLD_SIZE={world}")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")

    def card(r: int) -> torch.device:
        if dev.type != "cuda":
            return dev
        return torch.device("cuda", r % torch.cuda.device_count())

    local = card(int(os.environ.get("LOCAL_RANK", rank)))
    if dev.type == "cuda":
        torch.cuda.set_device(local)
    if not dist.is_initialized():
        kw = {"device_id": local} if backend == "nccl" else {}
        dist.init_process_group(
            backend, init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                                  f"{os.environ['MASTER_PORT']}"),
            world_size=world, rank=rank, **kw)
    elif (dist.get_rank(), dist.get_world_size()) != (rank, world):
        raise RuntimeError(
            f"the process group is rank {dist.get_rank()} of "
            f"{dist.get_world_size()}, the environment says {rank} of "
            f"{world}")
    s = shards_per_process
    devices = tuple(local if d // s == rank else card(d // s)
                    for d in range(world * s))
    return Mesh(devices, process=ProcessGroup(
        rank=rank, world_size=world, shards_per_process=s,
        backend=dist.get_backend()))


def shutdown() -> None:
    """Leave the process group (if this process joined one)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
