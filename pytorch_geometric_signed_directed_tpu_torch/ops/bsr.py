"""Block-sparse-row operators: the host layout and the autograd entry of
the ``bsr`` tier.

Counterpart of ``pytorch_geometric_signed_directed_tpu/ops/pallas/
bsr_spmm.py`` (``BSR``, ``_bsr_arrays``, ``bsr_from_coo``, ``bsr_spmm``).
The blocks are built on the host with numpy (the same arrays as the JAX
package's for the same input) and moved to the operator's device; the
apply is the kernel of ``ops/cuda/bsr_spmm.cu`` and its backward is the
same kernel on the transposed BSR.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .coo import COO
from .cuda.bsr_spmm import BLOCK, bsr_matmul, plan_block_split, sm_count
from .cuda.scatter_csr import RowSplit

# The JAX package caps the block count for the TPU's scalar memory and
# HBM; the cap is kept so that both packages take the same graphs (100k
# blocks are 6.6 GB of float32).
_MAX_BLOCKS = 100_000


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class BSR:
    """Block-sparse-row matrix of 128×128 dense float32 blocks.

    Every block row appears at least once in ``block_rows`` (an empty row
    gets one zero block, as in the JAX package).

    Attributes:
        blocks: [NB, 128, 128] float32, sorted by (block_row, block_col).
        block_rows: [NB] int32 block-row index per block (non-decreasing).
        block_cols: [NB] int32 block-column index per block.
        block_rowptr: [ceil(num_rows/128)+1] int32 offsets of each block
            row's blocks.
        num_rows / num_cols: logical (unpadded) matrix dims.
        transposed: the same matrix in transposed BSR form (the backward;
            None on the transpose itself).
        split: the kernel's plan of the block rows' pieces
            (``plan_block_split``), made once here.
    """

    blocks: torch.Tensor
    block_rows: torch.Tensor
    block_cols: torch.Tensor
    block_rowptr: torch.Tensor
    num_rows: int
    num_cols: int
    transposed: Optional["BSR"] = None
    split: Optional[RowSplit] = None


def _bsr_arrays(row, col, val, num_rows, num_cols):
    """Group COO entries into sorted 128x128 blocks, covering every row."""
    rb = _round_up(max(num_rows, 1), BLOCK) // BLOCK
    cb = _round_up(max(num_cols, 1), BLOCK) // BLOCK
    bid = (row // BLOCK) * cb + (col // BLOCK)
    uniq, inv = np.unique(bid, return_inverse=True)
    # One zero block for every block-row with no entries, so the kernel
    # initialises (zeroes) every output tile.
    missing_rows = np.setdiff1d(np.arange(rb), uniq // cb)
    all_bids = np.concatenate([uniq, missing_rows * cb]).astype(np.int64)
    order = np.argsort(all_bids, kind="stable")
    all_bids = all_bids[order]
    # Position of each original unique block after the merge-sort.
    pos_of_uniq = np.searchsorted(all_bids, uniq)
    nb = len(all_bids)
    blocks = np.zeros((nb, BLOCK, BLOCK), np.float32)
    np.add.at(blocks, (pos_of_uniq[inv], row % BLOCK, col % BLOCK), val)
    return blocks, (all_bids // cb).astype(np.int32), (all_bids % cb).astype(np.int32)


def _to_device(blocks, brows, bcols, num_rows, num_cols, device, t=None):
    rb = _round_up(max(num_rows, 1), BLOCK) // BLOCK
    rowptr = np.concatenate(
        [[0], np.cumsum(np.bincount(brows, minlength=rb))]).astype(np.int32)
    rowptr = torch.from_numpy(rowptr).to(device)
    return BSR(blocks=torch.from_numpy(blocks).to(device),
               block_rows=torch.from_numpy(brows).to(device),
               block_cols=torch.from_numpy(bcols).to(device),
               block_rowptr=rowptr, num_rows=num_rows, num_cols=num_cols,
               transposed=t,
               split=plan_block_split(rowptr, len(blocks), sm_count(device)))


def bsr_from_coo(A: COO) -> BSR:
    """Build ``A`` and its transpose on the host (``A`` on any device),
    then move both to A's device.

    BSR pays 128x128 dense work per touched block: it is only profitable
    when edges are concentrated (ops.reorder.rcm_permutation /
    block_density tell).  Graphs whose edges touch more than _MAX_BLOCKS
    blocks are rejected — use the segment or mxu tier there."""
    row = A.row.cpu().numpy().astype(np.int64)
    col = A.col.cpu().numpy().astype(np.int64)
    val = A.val.cpu().numpy().astype(np.float32)
    cb = _round_up(max(A.num_cols, 1), BLOCK) // BLOCK
    n_blocks = len(np.unique((row // BLOCK) * cb + (col // BLOCK)))
    if n_blocks > _MAX_BLOCKS:
        raise ValueError(
            f"graph touches {n_blocks} 128x128 blocks (> {_MAX_BLOCKS}); "
            "reorder the graph (ops.reorder) or use the segment or mxu tier")
    device = A.val.device
    t = _to_device(*_bsr_arrays(col, row, val, A.num_cols, A.num_nodes),
                   A.num_cols, A.num_nodes, device)
    return _to_device(*_bsr_arrays(row, col, val, A.num_nodes, A.num_cols),
                      A.num_nodes, A.num_cols, device, t)


def _bsr_forward(A: BSR, x: torch.Tensor) -> torch.Tensor:
    out = bsr_matmul(A.blocks, A.block_rowptr, A.block_cols,
                     x.to(torch.float32).contiguous(), A.num_rows, A.split)
    return out.to(x.dtype)


class _BsrSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, A):
        ctx.A = A
        return _bsr_forward(A, x)

    @staticmethod
    def backward(ctx, g):
        return _bsr_forward(ctx.A.transposed, g), None


def bsr_spmm(A: BSR, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` with x: [num_cols, F] -> [num_rows, F].  The backward is
    the same kernel on ``A.transposed``."""
    return _BsrSpmm.apply(x, A)
