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
