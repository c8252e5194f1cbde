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
from .coalesce import coalesce_edges


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

    def _host_values(self) -> np.ndarray:
        """The values in host memory, float64 kept, others as float32."""
        v = self.val.detach().cpu()
        return (v if v.dtype == torch.float64 else v.float()).numpy()

    def transpose(self) -> "COO":
        """The transposed matrix, sorted by its own (row, col), on this
        one's device with its value type (host-side, as in JAX)."""
        return build_coo(self.col.cpu().numpy(), self.row.cpu().numpy(),
                         self._host_values(), self.num_cols,
                         num_cols=self.num_nodes, dtype=self.val.dtype,
                         device=self.val.device)

    def to_scipy(self):
        """A scipy CSR matrix of the same entries (duplicates summed)."""
        import scipy.sparse as sp

        return sp.coo_matrix(
            (self._host_values(),
             (self.row.cpu().numpy(), self.col.cpu().numpy())),
            shape=self.shape).tocsr()

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


def _torch_dtype(dtype) -> torch.dtype:
    """The torch type of a numpy or torch floating type."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


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
    pad_to: Optional[int] = None,
    pad_multiple: int = 8,
    dtype=np.float32,
    sum_duplicates: bool = False,
    device: DeviceLike = None,
) -> COO:
    """Host-side constructor: sorts by (row, col) and moves to ``device``.
    Duplicates are kept and sum when applied, or, with
    ``sum_duplicates``, summed here (in float32, as the JAX package does,
    or float64 for float64 values).

    Args:
        row/col: int arrays of destination / source indices.
        val: optional edge values (defaults to ones).
        num_nodes: number of rows; inferred as max index + 1 if omitted.
        num_cols: number of columns (defaults to num_nodes).
        pad_to / pad_multiple: accepted for the JAX signature and not
            read: the COO holds exactly its ``nnz`` entries, unpadded.
        dtype: the values' type (a numpy or torch floating type).
        device: target device; None means "cuda".
    """
    device = resolve_device(device)
    tdtype = _torch_dtype(dtype)
    host = np.float64 if tdtype == torch.float64 else np.float32
    row = np.asarray(row, dtype=np.int64).ravel()
    col = np.asarray(col, dtype=np.int64).ravel()
    if val is None:
        val = np.ones(len(row), dtype=host)
    else:
        val = np.asarray(val, dtype=host).ravel()
    if num_nodes is None:
        num_nodes = int(max(row.max(initial=-1), col.max(initial=-1)) + 1)
    if num_cols is None:
        num_cols = num_nodes

    check_indices(row, col, num_nodes, num_cols)
    if sum_duplicates and len(row):
        row, col, val = coalesce_edges(row, col, val, num_cols=num_cols)
        val = val.astype(host, copy=False)
    elif len(row) and not _is_rowcol_sorted(row, col):
        order = np.lexsort((col, row))
        row, col, val = row[order], col[order], val[order]

    return COO(
        row=torch.from_numpy(np.ascontiguousarray(row)).to(device),
        col=torch.from_numpy(np.ascontiguousarray(col)).to(device),
        val=torch.from_numpy(np.ascontiguousarray(val)).to(device, tdtype),
        num_nodes=int(num_nodes),
        num_cols=int(num_cols),
    )


def coo_from_scipy(A, pad_to: Optional[int] = None, pad_multiple: int = 8,
                   device: DeviceLike = None) -> COO:
    """A scipy sparse matrix as a COO on ``device`` (None means "cuda"),
    its stored entries kept as they are (explicit zeros and duplicates
    included) and stored as float32.  ``pad_to`` and ``pad_multiple`` are
    accepted for the JAX signature and not read (no padding)."""
    A = A.tocoo()
    return build_coo(A.row, A.col, A.data, A.shape[0], num_cols=A.shape[1],
                     device=device)
