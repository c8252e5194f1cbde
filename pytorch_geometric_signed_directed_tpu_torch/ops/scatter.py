"""K1's own contract with a gradient: segment sums of row-ordered messages.

Counterpart of ``scatter_sum`` and its VJP in ``pytorch_geometric_signed_
directed_tpu/ops/pallas/scatter_mxu.py``.  The TPU plan lays edges out in
windows and chunks for its one-hot matmuls; here a ``ScatterPlan`` is a
destination CSR: ``rowptr`` (int32, for the kernel), the row of every
message (``row_ids``, int64, for the backward's gather) and the
``RowSplit`` of the rowptr.  All three are made once, when the graph is
built, so a call makes no host sync.  The forward is
``scatter_csr.csr_scatter_sum`` (the kernel for CUDA tensors, its plain
version for CPU ones); the backward gathers ``g[row_ids]``.

The reverse, ``gather_rows(table, GatherPlan)``, is a row gather whose
backward is K1 over the positions sorted by row, reading the gradient
rows by index (no reordered copy of them): no sort and no atomics a
step, and a row gathered many times (a hub) is cut into pieces like any
long row.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .cuda.scatter_csr import RowSplit, csr_scatter_sum, plan_row_split


@dataclass(frozen=True)
class ScatterPlan:
    """A destination CSR over ``num_rows`` rows: messages come in row
    order, those of row r at ``[rowptr[r], rowptr[r + 1])``."""

    rowptr: torch.Tensor
    row_ids: torch.Tensor
    split: RowSplit
    num_rows: int


def build_scatter_plan(rows: np.ndarray, num_rows: int,
                       device: DeviceLike = None) -> ScatterPlan:
    """The plan of messages whose rows ``rows`` (in ``[0, num_rows)``) are
    sorted ascending."""
    device = resolve_device(device)
    rows = np.asarray(rows, np.int64)
    if len(rows) and (rows[0] < 0 or rows[-1] >= num_rows
                      or np.any(rows[1:] < rows[:-1])):
        raise ValueError("rows must be sorted and inside [0, num_rows)")
    counts = np.bincount(rows, minlength=num_rows)
    rowptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    rowptr = torch.from_numpy(rowptr).to(device)
    return ScatterPlan(rowptr=rowptr,
                       row_ids=torch.from_numpy(rows).to(device),
                       split=plan_row_split(rowptr), num_rows=num_rows)


class _ScatterSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, msgs, plan):
        ctx.plan = plan
        return csr_scatter_sum(plan.rowptr, msgs, plan.split)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.plan.row_ids], None


def scatter_sum(plan: ScatterPlan, msgs: torch.Tensor) -> torch.Tensor:
    """Segment sum of plan-ordered ``msgs [E, F]`` into ``[num_rows, F]``
    (float32; float64 for float64 messages on the CPU); rows without
    messages are 0.  Differentiable in ``msgs``: d msgs = g[row_ids]."""
    return _ScatterSum.apply(msgs.contiguous(), plan)


@dataclass(frozen=True)
class GatherPlan:
    """Rows ``index`` of a table of ``plan.num_rows`` rows, with the plan
    of the gather's backward: ``order`` sorts the positions by row, and
    ``plan`` sums the gradient rows so ordered into the table's rows."""

    index: torch.Tensor
    order: torch.Tensor
    plan: ScatterPlan


def build_gather_plan(index, num_rows: int,
                      device: DeviceLike = None) -> GatherPlan:
    """The plan of gathering rows ``index`` (in ``[0, num_rows)``)."""
    device = resolve_device(device)
    if isinstance(index, torch.Tensor):
        index = index.cpu().numpy()
    index = np.asarray(index, np.int64)
    order = np.argsort(index, kind="stable")
    return GatherPlan(index=torch.from_numpy(index).to(device),
                      order=torch.from_numpy(order).to(device),
                      plan=build_scatter_plan(index[order], num_rows, device))


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, gplan):
        ctx.gplan = gplan
        return table[gplan.index]

    @staticmethod
    def backward(ctx, g):
        gp = ctx.gplan
        return csr_scatter_sum(gp.plan.rowptr, g.contiguous(), gp.plan.split,
                               index=gp.order), None


def gather_rows(table: torch.Tensor, gplan: GatherPlan) -> torch.Tensor:
    """``table[gplan.index]``; differentiable in ``table``: its gradient is
    the K1 segment sum of the output's gradient rows by index, read in
    place (``csr_scatter_sum``'s indexed messages, ``index=order``)."""
    return _GatherRows.apply(table, gplan)
