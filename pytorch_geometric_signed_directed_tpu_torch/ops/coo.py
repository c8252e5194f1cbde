"""COO sparse matrix on a device — the container of the dense and segment
tiers.

Counterpart of ``pytorch_geometric_signed_directed_tpu/ops/coo.py``.  The
JAX container pads the edge list to a static length for XLA; PyTorch runs
eagerly, so here the tensors hold exactly the ``nnz`` valid entries.

Convention: an entry ``(row, col, val)`` means ``A[row, col] = val`` and
``spmm(A, x)[row] += val * x[col]`` — plain matrix multiplication.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


@dataclass(frozen=True)
class COO:
    """Row-sorted COO matrix.

    Attributes:
        row: [nnz] int64 destination (output) indices, sorted by (row, col).
        col: [nnz] int64 source indices.
        val: [nnz] float edge values.
        num_nodes: number of rows.
        num_cols: number of columns.
    """

    row: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    num_nodes: int
    num_cols: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.num_nodes, self.num_cols)

    @property
    def nnz(self) -> int:
        return int(self.row.numel())

    def to_dense(self) -> torch.Tensor:
        """Dense [N, M]; duplicate entries sum."""
        dense = torch.zeros(self.shape, dtype=self.val.dtype,
                            device=self.val.device)
        return dense.index_put_((self.row, self.col), self.val,
                                accumulate=True)


def _is_rowcol_sorted(row: np.ndarray, col: np.ndarray) -> bool:
    if len(row) < 2:
        return True
    r0, r1 = row[:-1], row[1:]
    return bool(np.all((r1 > r0) | ((r1 == r0) & (col[1:] >= col[:-1]))))


def check_indices(row: np.ndarray, col: np.ndarray, n_rows: int,
                  n_cols: int) -> None:
    """Reject edges outside the [n_rows, n_cols] operator: the kernels and
    ``index_add_`` would read or write out of bounds."""
    if len(row) and (row.min() < 0 or row.max() >= n_rows
                     or col.min() < 0 or col.max() >= n_cols):
        raise ValueError(f"edge index outside the [{n_rows}, {n_cols}] "
                         f"operator")


def build_coo(
    row,
    col,
    val=None,
    num_nodes: Optional[int] = None,
    *,
    num_cols: Optional[int] = None,
    device: DeviceLike = None,
) -> COO:
    """Host-side constructor: sorts by (row, col) (duplicates are kept and
    sum when applied) and moves to ``device``.

    Args:
        row/col: int arrays of destination / source indices.
        val: optional edge values (defaults to ones), stored as float32.
        num_nodes: number of rows; inferred as max index + 1 if omitted.
        num_cols: number of columns (defaults to num_nodes).
        device: target device; None means "cuda".
    """
    device = resolve_device(device)
    row = np.asarray(row, dtype=np.int64).ravel()
    col = np.asarray(col, dtype=np.int64).ravel()
    if val is None:
        val = np.ones(len(row), dtype=np.float32)
    else:
        val = np.asarray(val, dtype=np.float32).ravel()
    if num_nodes is None:
        num_nodes = int(max(row.max(initial=-1), col.max(initial=-1)) + 1)
    if num_cols is None:
        num_cols = num_nodes

    check_indices(row, col, num_nodes, num_cols)
    if len(row) and not _is_rowcol_sorted(row, col):
        order = np.lexsort((col, row))
        row, col, val = row[order], col[order], val[order]

    return COO(
        row=torch.from_numpy(np.ascontiguousarray(row)).to(device),
        col=torch.from_numpy(np.ascontiguousarray(col)).to(device),
        val=torch.from_numpy(np.ascontiguousarray(val)).to(device),
        num_nodes=int(num_nodes),
        num_cols=int(num_cols),
    )
