"""The attention tier across a mesh: softmax by destination, sharded.

Counterpart of ``pytorch_geometric_signed_directed_tpu/parallel/
attn_shard.py``.  SNEA, SiGAT and SDGNN aggregate per-edge messages
weighted by a softmax over the edges of each destination.  Under the
owner-computes row partition (shard d owns the rows [d * rows_per, (d + 1)
* rows_per), as parallel/mxu_shard.py) every destination's edges live on
one shard, so the softmax needs no communication:

  * on the host, a flat ``AttnGraph``'s edges are split by the owner of
    their destination, and each shard gets a destination CSR over its
    local rows (``ops.scatter.ScatterPlan``, plan of cut rows included),
    built once;
  * ``sharded_attention_apply`` (a ``ShardedAttnGraph``'s ``attend``, as
    the layers call it) runs the model's ``edge_fn`` on each
    shard's edges, shifts by the shard's own largest logit, and sums the
    stacked ``[exp | msgs * exp]`` into the shard's rows with K1
    ``csr_scatter_sum`` (through ``scatter_sum``, whose backward is a
    gather); ``all_gather`` re-assembles the rows, the one collective.

The TPU's window, chunk, dummy-chunk and ``visited`` geometry has no
counterpart: each shard is a plain CSR without padding, so ``valid`` is
all True and an edgeless shard's rows come out 0.  The tables and
parameters that ``edge_fn`` reads are replicated: on a mesh that spans
processes they pass through ``parallel.shard_input`` (``attend`` does
that), which sums their gradients over the processes (JAX's
``shard_map`` transposes its captured operands so).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch

from ..ops.scatter import ScatterPlan, build_scatter_plan, scatter_sum
from .mesh import Mesh, all_gather, shard_input


@dataclass(frozen=True)
class AttnShard:
    """One shard's edges in destination order: global ``src``/``dst``
    [E_d] int64, ``edge_p`` [E_d] int32, and the CSR ``plan`` over the
    shard's local rows."""

    src: torch.Tensor
    dst: torch.Tensor
    edge_p: torch.Tensor
    plan: ScatterPlan


@dataclass(frozen=True)
class ShardedAttnGraph:
    """An AttnGraph partitioned by destination row: ``shards`` are this
    process's (every shard on a controller's mesh)."""

    shards: Tuple[AttnShard, ...]
    num_nodes: int
    rows_per_device: int
    mesh: Mesh

    def attend(self, edge_fn: Callable, tables: tuple,
               aggregate: str) -> torch.Tensor:
        """``sharded_attention_apply`` of ``edge_fn(src, dst, edge_p,
        *tables)``, the tables put on the mesh (``shard_input``, once a
        tensor; None stays None).  ``aggregate`` is not read: every shard
        sums with K1."""
        placed = {}
        for t in tables:
            if t is not None and id(t) not in placed:
                placed[id(t)] = shard_input(t, self.mesh)
        ts = tuple(None if t is None else placed[id(t)] for t in tables)
        return sharded_attention_apply(
            self, lambda src, dst, ep, valid: edge_fn(src, dst, ep, *ts))


def shard_attention_graph(g, mesh: Mesh,
                          axis: str = "graph") -> ShardedAttnGraph:
    """Re-partition a built ``AttnGraph`` across ``axis`` (host side)."""
    from ..nn.signed.motif_stack import MotifStackGraph
    from ..nn.signed.snea_conv import AttnGraph

    if isinstance(g, MotifStackGraph):
        raise TypeError("a MotifStackGraph (fused=True) cannot be sharded; "
                        "build the motif graphs with fused=False")
    if not isinstance(g, AttnGraph):
        raise TypeError(f"shard_attention_graph takes an AttnGraph, got "
                        f"{type(g).__name__}")
    n = g.num_nodes
    rows_per = -(-max(n, 1) // mesh.graph_axis(axis))
    src = g.src.cpu().numpy()
    dst = g.dst.cpu().numpy()
    ep = g.edge_p.cpu().numpy()
    owner = dst // rows_per
    shards = []
    for d, dev in zip(mesh.local, mesh.local_devices):
        m = np.flatnonzero(owner == d)
        shards.append(AttnShard(
            src=torch.from_numpy(src[m]).to(dev),
            dst=torch.from_numpy(dst[m]).to(dev),
            edge_p=torch.from_numpy(ep[m]).to(dev),
            plan=build_scatter_plan(dst[m] - d * rows_per, rows_per,
                                    device=dev)))
    return ShardedAttnGraph(shards=tuple(shards), num_nodes=n,
                            rows_per_device=rows_per, mesh=mesh)


def sharded_attention_apply(
    sg: ShardedAttnGraph,
    edge_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
) -> torch.Tensor:
    """Softmax-by-destination aggregation of ``edge_fn``'s messages,
    sharded; returns the replicated [num_nodes, F] on the controller.

    ``edge_fn(src, dst, edge_p, valid) -> (logits [E_d], msgs [E_d, F])``
    runs once a shard on its edges (given on the controller, where the
    replicated tables live; ``valid`` is all True).  Each shard shifts by
    its own largest logit; the softmax is invariant to the shift, so the
    result matches the flat one's global shift to rounding.
    Differentiable."""
    # the flat aggregate's shift, taken over the shard's logits: its
    # largest, 0 where that is not finite or the shard has no edge
    from ..nn.signed.snea_conv import _global_shift

    ctrl = sg.mesh.controller
    outs = []
    for sh, dev in zip(sg.shards, sg.mesh.local_devices):
        valid = torch.ones(sh.src.shape, dtype=torch.bool, device=ctrl)
        logits, msgs = edge_fn(sh.src.to(ctrl), sh.dst.to(ctrl),
                               sh.edge_p.to(ctrl), valid)
        logits, msgs = logits.to(dev), msgs.to(dev)
        ex = torch.exp(logits - _global_shift(logits))[:, None]
        agg = scatter_sum(sh.plan, torch.cat([ex, msgs * ex], dim=1))
        denom = agg[:, :1].clamp_min(torch.finfo(logits.dtype).tiny)
        outs.append(agg[:, 1:] / denom)
    return all_gather(outs, sg.mesh)[:sg.num_nodes]


def shard_attention_graphs(graphs, mesh: Mesh, axis: str = "graph"):
    """Shard every AttnGraph of a model's graphs: SNEA's (g_pos, g_neg,
    g_cat) tuple or the SiGAT / SDGNN motif lists (tuple in, tuple out;
    list in, list out).  A ``MotifStackGraph`` (``fused=True``) raises a
    TypeError."""
    from ..nn.signed.motif_stack import MotifStackGraph

    if isinstance(graphs, MotifStackGraph):
        raise TypeError("a MotifStackGraph (fused=True) cannot be sharded; "
                        "prepare the motif graphs with fused=False")
    out = [shard_attention_graph(g, mesh, axis) for g in graphs]
    return tuple(out) if isinstance(graphs, tuple) else out
