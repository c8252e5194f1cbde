"""The kernel tier across a device mesh (owner-computes row partition).

Counterpart of ``pytorch_geometric_signed_directed_tpu/parallel/
mxu_shard.py``.  Shard d owns the output rows [d * rows_per, (d + 1) *
rows_per) with ``rows_per = ceil(N / D)``, and holds its edges as one CSR
over those local rows (ops/layout.py; column-split by its own column
degrees when the layout knobs say so, never streamed).  An apply runs the
kernel of each shard on its device against the replicated input (K1, or K2
on a split shard), then ``all_gather`` puts the row blocks back together;
the backward is the same on the transposed partition.  The TPU's
window/chunk geometry and its stacking of per-device plans have no
counterpart: each shard is a plain CSR.  On a mesh that spans processes
(parallel/distributed.py) a process builds and runs only its own shards,
and the gather and sum go through ``torch.distributed``.

Trainable-q templates shard the same way, carrying (a_norm, theta) in the
value slots; their backward runs the fused scatter + SDDMM kernel (K3) per
shard, gathers dx and sums the shards' dq partials with ``psum``.

One deliberate difference: with bf16 messages the JAX package also rounds
the all-gathered result to bf16 (to halve the collective's bytes); the
controller's concatenation moves no bytes between chips, so here the
result stays float32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cuda.scatter_csr import _row_ids
from ..ops.layout import CsrLayout, build_layout
from ..ops.sddmm import dual_scatter_sddmm
from ..ops.spmm import _kernel_dtype, _layout_apply
from ..spectral.magnetic import MagneticTemplate, _template_terms
from .mesh import Mesh, all_gather, psum


@dataclass(frozen=True)
class MxuShard:
    """One device's edges: a CSR over its local rows and the per-edge
    values in that layout's order (``val_b`` for a fused pair)."""

    layout: CsrLayout
    val: torch.Tensor
    val_b: Optional[torch.Tensor]


@dataclass(frozen=True)
class ShardedMXU:
    """An operator (or a fused pair) partitioned by output rows:
    ``shards`` are this process's (``mesh.local``), every shard on a
    controller's mesh."""

    shards: Tuple[MxuShard, ...]
    num_rows: int
    num_cols: int
    rows_per_device: int
    mesh: Mesh
    transposed: Optional["ShardedMXU"] = None

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    @property
    def hot_ids(self) -> Tuple[Optional[torch.Tensor], ...]:
        """Each local shard's hot table (None where the shard is
        unsplit)."""
        return tuple(s.layout.hot_ids for s in self.shards)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ x`` (or the lane-stacked pair ``[A x_a | B x_b]``) for the
        replicated ``x`` [num_cols, F]; returns [num_rows, F] on the
        controller.  No autograd: ``apply`` and ``dual_spmm_stacked`` run
        it inside their Functions."""
        fa = x.shape[1] if self.shards[0].val_b is None else x.shape[1] // 2
        outs = []
        for sh, dev in zip(self.shards, self.mesh.local_devices):
            vb = sh.val if sh.val_b is None else sh.val_b
            outs.append(_layout_apply(sh.layout, sh.val, vb,
                                      self.rows_per_device, x.to(dev), fa))
        return all_gather(outs, self.mesh)[:self.num_rows]

    # a fused pair's lane-stacked forward (``ops.spmm.dual_spmm_stacked``)
    forward_stacked = forward

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ x`` across the mesh, differentiable through the
        transposed partition."""
        if self.transposed is None:
            raise ValueError("build_sharded_mxu(with_transpose=False) is "
                             "not differentiable")
        return _ShardedSpmm.apply(x, self)

    def template_dual_apply(self, q: torch.Tensor,
                            x: torch.Tensor) -> torch.Tensor:
        """``[L_re x_a | L_im x_b]`` for phase ``q`` across the mesh, of a
        template sharded by ``build_sharded_template``; differentiable in
        q and x."""
        if self.transposed is None:
            raise ValueError("sharded template built without a transpose")
        return _ShardedTemplateApply.apply(x, q, self)


def build_sharded_mxu(row, col, val, num_rows: int, num_cols: int,
                      mesh: Mesh, axis: str = "graph", val_b=None,
                      with_transpose: bool = True,
                      col_split: bool = True) -> ShardedMXU:
    """Host-side builder from valid COO arrays (numpy), sharded across
    ``axis``.  ``col_split=False`` keeps every shard unsplit
    (trainable-value layouts, whose fused backward runs on flat CSRs)."""
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    val = np.asarray(val, np.float32)
    val_b = None if val_b is None else np.asarray(val_b, np.float32)
    t = None
    if with_transpose:
        t = build_sharded_mxu(col, row, val, num_cols, num_rows, mesh, axis,
                              val_b=val_b, with_transpose=False,
                              col_split=col_split)
    rows_per = -(-max(num_rows, 1) // mesh.graph_axis(axis))
    owner = row // rows_per
    shards = []
    for d in mesh.local:
        dev = mesh.devices[d]
        m = owner == d
        L, p = build_layout(row[m] - d * rows_per, col[m], rows_per,
                            num_cols, dev, col_split=col_split, stream=False)

        def place(v):
            return torch.from_numpy(v[m]).to(dev)[p].contiguous()

        shards.append(MxuShard(layout=L, val=place(val),
                               val_b=None if val_b is None else place(val_b)))
    return ShardedMXU(shards=tuple(shards), num_rows=num_rows,
                      num_cols=num_cols, rows_per_device=rows_per, mesh=mesh,
                      transposed=t)


class _ShardedSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, S):
        ctx.S = S
        return S.forward(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.S.transposed.forward(g.contiguous()), None


def sharded_mxu_spmm(S: ShardedMXU, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` across the mesh, differentiable through the transposed
    partition (``S.apply``)."""
    return S.apply(x)


# ---------------------------------------------------------------------------
# Host-side extraction of the edges of built single-device operators, so
# that shard_propagator / shard_dual re-partition without the raw edges.


def _planned_valid_edges(op) -> Tuple[np.ndarray, np.ndarray]:
    """(rows, positions) of the edges of a kernel-tier layout (a CSR, an
    mxu DualPropagator or an mxu MagneticTemplate), in layout order.  The
    card's layouts hold no padding, so every position is an edge."""
    if not op.blocks:
        rows = _row_ids(op.rowptr)
    else:
        rows = torch.cat([_row_ids(b.rowptr) + b.row0 for b in op.blocks])
    rows = rows.cpu().numpy()
    return rows, np.arange(len(rows))


def _unsplit_cols(op, valid_idx: np.ndarray) -> np.ndarray:
    """Original column ids of the given layout positions: the hot blocks
    of a column-split layout hold indices into ``x[hot_ids]``."""
    col = op.col.cpu().numpy().astype(np.int64)[valid_idx]
    if op.hot_ids is None:
        return col
    hot_edges = op.blocks[op.hot_blocks - 1].e1 if op.hot_blocks else 0
    is_hot = valid_idx < hot_edges
    col[is_hot] = op.hot_ids.cpu().numpy()[col[is_hot]]
    return col


def _coo_from_mxu(csr) -> tuple:
    """(row, col, val) numpy triples of the edges of a kernel-tier CSR."""
    rows, valid = _planned_valid_edges(csr)
    return rows, _unsplit_cols(csr, valid), csr.val.cpu().numpy()[valid]


def _coo_from_dual(d) -> tuple:
    """(row, col, val_a, val_b) of the edges of an mxu DualPropagator."""
    rows, valid = _planned_valid_edges(d)
    return (rows, _unsplit_cols(d, valid), d.val_a.cpu().numpy()[valid],
            d.val_b.cpu().numpy()[valid])


# ---------------------------------------------------------------------------
# Sharded trainable-q templates


def build_sharded_template(tmpl, mesh: Mesh, axis: str = "graph"):
    """Re-partition a built mxu MagneticTemplate across the mesh: a
    MagneticTemplate of mode "mxu_sharded" whose ``sharded`` carries
    (a_norm, theta) in its (val, val_b) slots, every shard unsplit.  Apply
    it with spectral.template_dual_apply."""
    rows, valid = _planned_valid_edges(tmpl)
    col = _unsplit_cols(tmpl, valid)
    a = tmpl.a_norm.cpu().numpy()[valid]
    th = tmpl.theta.cpu().numpy()[valid]
    S = build_sharded_mxu(rows, col, a, tmpl.num_nodes, tmpl.num_nodes, mesh,
                          axis, val_b=th, col_split=False)
    return MagneticTemplate(a_norm=None, theta=None, row=None, col=None,
                            num_nodes=tmpl.num_nodes, mode="mxu_sharded",
                            sharded=S)


def _sharded_template_forward(S: ShardedMXU, q, x: torch.Tensor):
    fa = x.shape[1] // 2
    outs = []
    for sh, dev in zip(S.shards, S.mesh.local_devices):
        va, vb, _, _ = _template_terms(sh.val, sh.val_b, q.to(dev))
        outs.append(_layout_apply(sh.layout, va, vb, S.rows_per_device,
                                  x.to(dev), fa))
    return all_gather(outs, S.mesh)[:S.num_rows]


class _ShardedTemplateApply(torch.autograd.Function):
    """Forward: K1 per shard.  Backward: the fused scatter + SDDMM (K3)
    per shard of the transposed partition, whose rows are x's rows: dx is
    the all-gather of its outputs, dq the psum of its lane partials."""

    @staticmethod
    def forward(ctx, x, q, S):
        ctx.S = S
        ctx.save_for_backward(x, q)
        return _sharded_template_forward(S, q, x)

    @staticmethod
    def backward(ctx, g):
        x, q = ctx.saved_tensors
        T = ctx.S.transposed
        rp, mdt = T.rows_per_device, _kernel_dtype(g)
        fa = x.shape[1] // 2
        x_pad = F.pad(x.float(), (0, 0, 0, rp * T.n_devices - x.shape[0]))
        outs, partials = [], []
        for d, sh in zip(T.mesh.local, T.shards):
            dev = T.mesh.devices[d]
            va, vb, wa, wb = _template_terms(sh.val, sh.val_b, q.to(dev))
            out, acc = dual_scatter_sddmm(
                sh.layout, g.to(device=dev, dtype=mdt).contiguous(), va, vb,
                wa, wb, x_pad[d * rp:(d + 1) * rp].to(dev).contiguous(), fa)
            outs.append(out)
            partials.append(acc.sum())
        dx = None
        if ctx.needs_input_grad[0]:
            dx = all_gather(outs, T.mesh)[:T.num_rows].to(g.dtype)
        dq = psum(partials, T.mesh).to(q.dtype).reshape(q.shape)
        return dx, dq, None


def sharded_template_dual_apply(S: ShardedMXU, q: torch.Tensor,
                                x: torch.Tensor) -> torch.Tensor:
    """``[L_re x_a | L_im x_b]`` for phase ``q`` across the mesh,
    differentiable in q and x (``S.template_dual_apply``)."""
    return S.template_dual_apply(q, x)
