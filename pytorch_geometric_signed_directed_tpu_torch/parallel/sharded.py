"""Sharding a built operator, pair or template across a mesh.

Counterpart of ``pytorch_geometric_signed_directed_tpu/parallel/
sharded.py``.  Every tier takes the owner-computes row partition of
parallel/mxu_shard.py: shard d owns the output rows [d * rows_per, (d + 1)
* rows_per), computes them on its device from the replicated input, and
``all_gather`` re-assembles the rows.

  * dense — shard d holds rows [d * rows_per, ...) of the [N, M] operator
    (zero rows pad the last blocks) and applies ``torch.matmul``;
  * segment — the edges grouped by the owner of their destination row,
    each shard a gather and a segment sum into its local rows;
  * bsr — whole 128-row block rows, ``ceil(block_rows / D)`` a shard, each
    shard a BSR of its own with its own block-split plan, applied by the
    block-sparse kernel K5; the backward is K5 on the shards of the
    transposed BSR, partitioned the same way;
  * mxu — parallel/mxu_shard.py.

The mode strings stay those of the JAX package: a sharded dense, segment or
bsr operator keeps its mode and carries its shards in ``sharded``; the mxu
tier becomes ``mxu_sharded``.  Frozen operators of the dense and segment
tiers and the sharded templates' values differentiate through autograd
(replicated inputs pass ``shard_input``); the bsr tier, the segment pair and
the mxu tier run their backward on the transposed partition.  As in
parallel/mxu_shard.py, the gathered result stays float32 where the JAX
package would round a bf16 gather to bf16.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.bsr import BSR
from ..ops.cuda.bsr_spmm import BLOCK, bsr_matmul, plan_block_split, sm_count
from ..ops.segment import segment_sum
from ..ops.spmm import DualPropagator, Propagator, _dense_apply
from ..spectral.magnetic import MagneticPair, MagneticTemplate, _edge_values
from .mesh import Mesh, all_gather, shard_input
from .mxu_shard import (
    _coo_from_dual,
    _coo_from_mxu,
    build_sharded_mxu,
    build_sharded_template,
)


def replicate(tree, mesh: Mesh):
    """Place a tensor or module (or a dict, list or tuple of them) on this
    process's controller device, where the sharded applies read their
    replicated inputs."""
    if isinstance(tree, (torch.Tensor, torch.nn.Module)):
        return tree.to(mesh.controller)
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    return tree


def _rows_per(num_rows: int, mesh: Mesh, axis: str) -> int:
    return -(-max(num_rows, 1) // mesh.graph_axis(axis))


# ---------------------------------------------------------------------------
# dense


@dataclass(frozen=True)
class ShardedDense:
    """Row blocks [rows_per, num_cols] of a dense operator, one a local
    shard (``blocks_b``: a template's theta blocks beside its a_norm)."""

    blocks: Tuple[torch.Tensor, ...]
    num_rows: int
    num_cols: int
    rows_per_device: int
    mesh: Mesh
    blocks_b: Optional[Tuple[torch.Tensor, ...]] = None

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        xs = shard_input(x, self.mesh)
        outs = [_dense_apply(b, xs.to(dev))
                for b, dev in zip(self.blocks, self.mesh.local_devices)]
        return all_gather(outs, self.mesh)[:self.num_rows]

    def template_propagators(self, q) -> Tuple[Propagator, Propagator]:
        """(L_hat_re, L_hat_im) for phase ``q`` of a sharded dense
        template: each block's values from its own (a_norm, theta),
        carrying q's gradient (summed over the processes of a process
        mesh)."""
        qs = shard_input(q, self.mesh)
        vals = [_edge_values(a, th, qs.to(a.device))
                for a, th in zip(self.blocks, self.blocks_b)]
        return tuple(
            Propagator(coo=None, dense=None, mode="dense",
                       sharded=dataclasses.replace(
                           self, blocks=tuple(v[i] for v in vals),
                           blocks_b=None))
            for i in (0, 1))


def _dense_blocks(dense: torch.Tensor, mesh: Mesh, rp: int):
    out = []
    for d, dev in zip(mesh.local, mesh.local_devices):
        blk = dense[d * rp:(d + 1) * rp]
        if blk.shape[0] < rp:
            blk = torch.cat([blk, blk.new_zeros((rp - blk.shape[0],)
                                                + blk.shape[1:])])
        out.append(blk.to(dev).contiguous())
    return tuple(out)


def shard_dense(dense: torch.Tensor, mesh: Mesh, axis: str = "graph",
                dense_b: Optional[torch.Tensor] = None) -> ShardedDense:
    rp = _rows_per(dense.shape[0], mesh, axis)
    return ShardedDense(
        blocks=_dense_blocks(dense, mesh, rp), num_rows=dense.shape[0],
        num_cols=dense.shape[1], rows_per_device=rp, mesh=mesh,
        blocks_b=None if dense_b is None else _dense_blocks(dense_b, mesh,
                                                           rp))


# ---------------------------------------------------------------------------
# segment


@dataclass(frozen=True)
class SegmentShard:
    """One shard's edges: int64 local rows and global columns, values
    (``val_b``: a pair's second values, or a template's theta)."""

    row: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    val_b: Optional[torch.Tensor] = None


@dataclass(frozen=True)
class ShardedSegment:
    """An operator, pair or template of the segment tier partitioned by
    destination row; ``transposed`` is the transpose's partition (a
    pair's backward)."""

    shards: Tuple[SegmentShard, ...]
    num_rows: int
    num_cols: int
    rows_per_device: int
    mesh: Mesh
    transposed: Optional["ShardedSegment"] = None

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ x``, differentiable through autograd (values included)."""
        xs = shard_input(x, self.mesh)
        outs = []
        for sh, dev in zip(self.shards, self.mesh.local_devices):
            xd = xs.to(dev)
            outs.append(segment_sum(sh.val[:, None] * xd[sh.col], sh.row,
                                    self.rows_per_device))
        return all_gather(outs, self.mesh)[:self.num_rows]

    def forward_stacked(self, x: torch.Tensor) -> torch.Tensor:
        """``[A x_a | B x_b]`` of a pair for the lane-stacked x."""
        fa = x.shape[1] // 2
        outs = []
        for sh, dev in zip(self.shards, self.mesh.local_devices):
            xd = x.to(dev)
            lane = torch.arange(2 * fa, device=dev) < fa
            msgs = xd[sh.col] * torch.where(lane[None, :], sh.val[:, None],
                                            sh.val_b[:, None])
            outs.append(segment_sum(msgs, sh.row, self.rows_per_device))
        return all_gather(outs, self.mesh)[:self.num_rows]

    def template_propagators(self, q) -> Tuple[Propagator, Propagator]:
        """(L_hat_re, L_hat_im) for phase ``q`` of a sharded segment
        template: each shard's values from its own (a_norm, theta),
        carrying q's gradient (summed over the processes of a process
        mesh)."""
        qs = shard_input(q, self.mesh)
        vals = [_edge_values(sh.val, sh.val_b, qs.to(sh.val.device))
                for sh in self.shards]
        return tuple(
            Propagator(coo=None, dense=None, mode="segment",
                       sharded=dataclasses.replace(self, shards=tuple(
                           SegmentShard(row=sh.row, col=sh.col, val=v[i])
                           for sh, v in zip(self.shards, vals))))
            for i in (0, 1))


def shard_segment(row, col, val, num_rows: int, num_cols: int, mesh: Mesh,
                  axis: str = "graph", val_b=None,
                  with_transpose: bool = False) -> ShardedSegment:
    """Partition the edges (tensors on any device) by the owner of their
    destination row, keeping their order within a shard."""
    t = None
    if with_transpose:
        t = shard_segment(col, row, val, num_cols, num_rows, mesh, axis,
                          val_b=val_b)
    rp = _rows_per(num_rows, mesh, axis)
    owner = row.cpu().numpy() // rp
    shards = []
    for d, dev in zip(mesh.local, mesh.local_devices):
        m = torch.from_numpy(np.flatnonzero(owner == d))

        def take(v):
            return None if v is None else v[m.to(v.device)].to(dev)

        shards.append(SegmentShard(row=take(row) - d * rp, col=take(col),
                                   val=take(val), val_b=take(val_b)))
    return ShardedSegment(shards=tuple(shards), num_rows=num_rows,
                          num_cols=num_cols, rows_per_device=rp, mesh=mesh,
                          transposed=t)


# ---------------------------------------------------------------------------
# bsr


@dataclass(frozen=True)
class ShardedBSR:
    """Whole block rows of a BSR, ``blocks_per_device`` a shard (a BSR of
    ``rows_per_device = 128 * blocks_per_device`` rows with its own plan),
    and the transposed BSR partitioned the same way."""

    shards: Tuple[BSR, ...]
    num_rows: int
    num_cols: int
    rows_per_device: int
    mesh: Mesh
    transposed: Optional["ShardedBSR"] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [bsr_matmul(b.blocks, b.block_rowptr, b.block_cols,
                           x.to(device=dev, dtype=torch.float32).contiguous(),
                           b.num_rows, b.split)
                for b, dev in zip(self.shards, self.mesh.local_devices)]
        return all_gather(outs, self.mesh)[:self.num_rows].to(x.dtype)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return _ShardedBsrSpmm.apply(x, self)


class _ShardedBsrSpmm(torch.autograd.Function):
    """K5 per shard; the backward is K5 per shard of the transposed
    partition."""

    @staticmethod
    def forward(ctx, x, S):
        ctx.S = S
        return S.forward(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.S.transposed.forward(g.contiguous()), None


def _bsr_shards(A: BSR, mesh: Mesh, axis: str):
    n_br = A.block_rowptr.numel() - 1
    per = -(-n_br // mesh.graph_axis(axis))
    ptr = A.block_rowptr.cpu().numpy().astype(np.int64)
    shards = []
    for d, dev in zip(mesh.local, mesh.local_devices):
        b0, b1 = min(d * per, n_br), min((d + 1) * per, n_br)
        e0, e1 = int(ptr[b0]), int(ptr[b1])
        local = np.full(per + 1, e1 - e0, np.int64)
        local[:b1 - b0 + 1] = ptr[b0:b1 + 1] - e0
        rowptr = torch.from_numpy(local.astype(np.int32)).to(dev)
        shards.append(BSR(
            blocks=A.blocks[e0:e1].to(dev).contiguous(),
            block_rows=(A.block_rows[e0:e1] - b0).to(dev),
            block_cols=A.block_cols[e0:e1].to(dev).contiguous(),
            block_rowptr=rowptr, num_rows=per * BLOCK, num_cols=A.num_cols,
            split=plan_block_split(rowptr, e1 - e0, sm_count(dev))))
    return tuple(shards), per * BLOCK


def shard_bsr(A: BSR, mesh: Mesh, axis: str = "graph") -> ShardedBSR:
    t = None
    if A.transposed is not None:
        ts, tr = _bsr_shards(A.transposed, mesh, axis)
        t = ShardedBSR(shards=ts, num_rows=A.num_cols, num_cols=A.num_rows,
                       rows_per_device=tr, mesh=mesh)
    shards, rp = _bsr_shards(A, mesh, axis)
    return ShardedBSR(shards=shards, num_rows=A.num_rows,
                      num_cols=A.num_cols, rows_per_device=rp, mesh=mesh,
                      transposed=t)


# ---------------------------------------------------------------------------
# the entry points


def shard_propagator(prop: Propagator, mesh: Mesh,
                     axis: str = "graph") -> Propagator:
    """Shard a Propagator's operator across ``axis`` of ``mesh``."""
    if prop.mode == "dense":
        return Propagator(coo=None, dense=None, mode="dense",
                          sharded=shard_dense(prop.dense, mesh, axis))
    if prop.mode == "segment":
        A = prop.coo
        return Propagator(coo=None, dense=None, mode="segment",
                          sharded=shard_segment(A.row, A.col, A.val,
                                                A.num_nodes, A.num_cols,
                                                mesh, axis))
    if prop.mode == "mxu":
        row, col, val = _coo_from_mxu(prop.csr)
        S = build_sharded_mxu(row, col, val, prop.csr.num_rows,
                              prop.csr.num_cols, mesh, axis)
        return Propagator(coo=None, dense=None, mode="mxu_sharded",
                          sharded=S)
    if prop.mode == "bsr":
        return Propagator(coo=None, dense=None, mode="bsr",
                          sharded=shard_bsr(prop.bsr, mesh, axis))
    raise ValueError(f"cannot shard a {prop.mode!r} Propagator")


def shard_dual(dual, mesh: Mesh, axis: str = "graph"):
    """Shard a fused DualPropagator: an mxu pair into per-shard CSRs
    (``mxu_sharded``), a segment pair into per-shard edge groups (mode
    ``segment``), each with its transposed partition.  None stays None."""
    if dual is None:
        return None
    if dual.mode == "segment":
        S = shard_segment(dual.row, dual.col, dual.val_a, dual.num_nodes,
                          dual.num_cols, mesh, axis, val_b=dual.val_b,
                          with_transpose=True)

        def wrap_segment(s):
            if s is None:
                return None
            return DualPropagator(
                col=None, row=None, rowptr=None, val_a=None, val_b=None,
                num_nodes=s.num_rows, num_cols=s.num_cols, mode="segment",
                transposed=wrap_segment(s.transposed), sharded=s)

        return wrap_segment(S)
    if dual.mode != "mxu":
        raise ValueError(f"cannot shard a {dual.mode!r} DualPropagator")
    row, col, va, vb = _coo_from_dual(dual)
    S = build_sharded_mxu(row, col, va, dual.num_nodes, dual.num_cols, mesh,
                          axis, val_b=vb)

    def wrap(s):
        if s is None:
            return None
        return DualPropagator(
            col=None, row=None, rowptr=None, val_a=None, val_b=None,
            num_nodes=s.num_rows, num_cols=s.num_cols, mode="mxu_sharded",
            transposed=wrap(s.transposed), sharded=s)

    return wrap(S)


def shard_magnet_laplacian(lap, mesh: Mesh, axis: str = "graph"):
    """Shard a MagneticPair, a (P_re, P_im) pair or a MagneticTemplate
    (dense, segment or mxu)."""
    if isinstance(lap, MagneticPair):
        return MagneticPair(re=shard_propagator(lap.re, mesh, axis),
                            im=shard_propagator(lap.im, mesh, axis),
                            dual=shard_dual(lap.dual, mesh, axis))
    if isinstance(lap, MagneticTemplate):
        if lap.mode == "mxu":
            return build_sharded_template(lap, mesh, axis)
        if lap.mode == "mxu_sharded" or lap.sharded is not None:
            return lap
        if lap.mode == "dense":
            S = shard_dense(lap.a_norm, mesh, axis, dense_b=lap.theta)
        elif lap.mode == "segment":
            S = shard_segment(lap.row, lap.col, lap.a_norm, lap.num_nodes,
                              lap.num_nodes, mesh, axis, val_b=lap.theta)
        else:
            raise ValueError(f"cannot shard a {lap.mode!r} MagneticTemplate")
        return MagneticTemplate(a_norm=None, theta=None, row=None, col=None,
                                num_nodes=lap.num_nodes, mode=lap.mode,
                                sharded=S)
    P_re, P_im = lap
    return (shard_propagator(P_re, mesh, axis),
            shard_propagator(P_im, mesh, axis))

