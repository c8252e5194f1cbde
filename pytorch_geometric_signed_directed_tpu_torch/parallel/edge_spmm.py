"""The edge-partitioned SpMM (owner-computes), by hand.

Counterpart of ``pytorch_geometric_signed_directed_tpu/parallel/
edge_spmm.py``.  On the host the edges are split by the owner of their
destination row (device d owns the rows [d * rows_per, (d + 1) *
rows_per)) and padded to one length ``E_max`` (a multiple of 8) with
local row ``rows_per``, which the segment sum drops.  ``sharded_spmm``
gathers the source rows of the replicated input on each shard, sums them
into the shard's own rows, and ``all_gather`` re-assembles the result: the
only collective.  ``partition_coo``'s arrays are the JAX package's, bit
for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.coo import COO
from ..ops.segment import segment_sum
from .mesh import Mesh, all_gather, shard_input


@dataclass(frozen=True)
class PartitionedCOO:
    """Per-device edge chunks stacked on a leading device axis: ``row``
    holds LOCAL row ids (``rows_per_device`` on padding), ``col`` global
    ones.  ``place`` leaves one [E_max] chunk a local shard on its
    device."""

    row: object   # [D, E_max] int32 (a tuple of [E_max] after place)
    col: object   # [D, E_max] int32
    val: object   # [D, E_max] float
    num_nodes: int
    num_cols: int
    rows_per_device: int
    n_devices: int


def partition_coo(A: COO, n_devices: int) -> PartitionedCOO:
    """Host-side 1-D row partition of a COO (numpy arrays, as the JAX
    package's)."""
    row = A.row.cpu().numpy()
    col = A.col.cpu().numpy()
    val = A.val.cpu().numpy()
    n = A.num_nodes
    rows_per = -(-n // n_devices)
    owner = row // rows_per
    counts = np.bincount(owner, minlength=n_devices)
    e_max = max(int(counts.max()) if counts.size else 0, 1)
    e_max = ((e_max + 7) // 8) * 8
    prow = np.full((n_devices, e_max), rows_per, np.int32)
    pcol = np.zeros((n_devices, e_max), np.int32)
    pval = np.zeros((n_devices, e_max), val.dtype)
    for d in range(n_devices):
        m = owner == d
        k = int(m.sum())
        prow[d, :k] = row[m] - d * rows_per
        pcol[d, :k] = col[m]
        pval[d, :k] = val[m]
    return PartitionedCOO(row=prow, col=pcol, val=pval, num_nodes=n,
                          num_cols=A.num_cols, rows_per_device=rows_per,
                          n_devices=n_devices)


def place(pcoo: PartitionedCOO, mesh: Mesh,
          axis: str = "graph") -> PartitionedCOO:
    """The chunks of this process's shards on their devices."""
    if mesh.graph_axis(axis) != pcoo.n_devices:
        raise ValueError(f"partitioned for {pcoo.n_devices} devices, the "
                         f"mesh has {mesh.size}")

    def put(a, dtype=None):
        return tuple(torch.from_numpy(np.asarray(a[d])).to(dev, dtype)
                     for d, dev in zip(mesh.local, mesh.local_devices))

    return PartitionedCOO(
        row=put(pcoo.row, torch.int64), col=put(pcoo.col, torch.int64),
        val=put(pcoo.val), num_nodes=pcoo.num_nodes,
        num_cols=pcoo.num_cols, rows_per_device=pcoo.rows_per_device,
        n_devices=pcoo.n_devices)


def sharded_spmm(pcoo: PartitionedCOO, x: torch.Tensor, mesh: Mesh,
                 axis: str = "graph") -> torch.Tensor:
    """``A @ x`` with owner-computes aggregation on a ``place``d
    partition; returns the replicated [num_nodes, F] result on the
    controller.  Differentiable."""
    mesh.graph_axis(axis)
    if isinstance(pcoo.row, np.ndarray):
        raise ValueError("sharded_spmm takes a placed partition: "
                         "place(partition_coo(A, D), mesh)")
    xs = shard_input(x, mesh)
    outs = []
    for row, col, val, dev in zip(pcoo.row, pcoo.col, pcoo.val,
                                  mesh.local_devices):
        msgs = val[:, None] * xs.to(dev)[col]
        outs.append(segment_sum(msgs, row, pcoo.rows_per_device))
    return all_gather(outs, mesh)[:pcoo.num_nodes]
