"""Layouts of the kernel tier for giant graphs: the hot/cold column split
and the streamed plan of row-ordered CSR blocks.

Counterpart of the layout half of ``pytorch_geometric_signed_directed_tpu/
ops/pallas/scatter_mxu.py`` (``col_degree_split`` and ``StreamPlan`` /
``_stream_from_host``).  The TPU layouts are windows and chunks padded
for one-hot matmuls; here every layout is plain CSR:

  * flat      one ``rowptr [N+1]`` over all edges in row order (K1);
  * split     edges whose column is among the ``GATHER_FAST_ROWS``
              highest-degree columns (the "hot" section, its col ids
              remapped into the compact table ``x[hot_ids]``) come first,
              then the rest (the "cold" section); each section is one
              CSR block over all rows, applied by the accumulate kernel
              (K2);
  * streamed  each section cut into blocks of at most
              ``STREAM_BLOCK_EDGES`` edges; a block holds the local
              ``rowptr`` of the rows it touches, and a row's edges may
              straddle blocks, which K2 sums in order.

Every rowptr (the flat one, each block's local one) comes with its plan of
cut rows (``scatter_csr.plan_row_split``, rows longer than
``scatter_csr.PIECE_EDGES`` edges cut into pieces that the kernels sum in
parallel), made here once so that an apply adds no host sync.

Why the split is kept on the card: the TPU split answers a gather cliff
(about 192k table rows on v5e).  On the H100 the analogue is the 50 MB
L2: at the giant graph's 2.4M rows x is 307 MB in bf16 at width 64, the
131,072-row hot table 16.8 MB, so the hot section's gathers hit L2.  The
layouts are chosen as the JAX package chooses them; since the kernels cut
hub rows, the flat layout applies the giant graph faster than the split
and streamed ones on an H100 (PERF.md, ROADMAP.md).

The module knobs are read at call time, so a caller (or a test) may set
them on this module before building an operator.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..instrument import span
from .cuda.scatter_csr import RowSplit, plan_row_split

# The column split: operators with more than COL_SPLIT_MIN_COLS columns
# gather the edges of their GATHER_FAST_ROWS highest-degree columns from
# a compact table, if those columns cover at least COL_SPLIT_MIN_COVERAGE
# of the edges.
GATHER_FAST_ROWS = 131_072
COL_SPLIT_MIN_COLS = 196_608
COL_SPLIT_MIN_COVERAGE = 0.25

# Operators with more than STREAM_THRESHOLD_EDGES nonzeros apply in blocks
# of at most STREAM_BLOCK_EDGES edges.  The one deliberate difference from
# the JAX package: it compares the PADDED plan length (windows and chunks
# padded for its one-hot matmuls); the card's layout has no padding, so
# this compares nnz.
STREAM_THRESHOLD_EDGES = 8_000_000
STREAM_BLOCK_EDGES = 4_000_000


def col_degree_split(col, num_cols: int):
    """Hot/cold edge partition by column degree.

    Returns None when the column space is at most COL_SPLIT_MIN_COLS or
    the hot table would cover too few edges; otherwise (group[e] in {0
    hot, 1 cold}, col_remapped[e], hot_ids[GATHER_FAST_ROWS]) where hot
    edges index the compact table x[hot_ids].  The same arrays as the JAX
    package's for the same input."""
    hot_rows = GATHER_FAST_ROWS
    if num_cols <= COL_SPLIT_MIN_COLS:
        return None
    col = np.asarray(col, np.int64)
    deg = np.bincount(col, minlength=num_cols)
    kth = num_cols - hot_rows
    hot_ids = np.argpartition(deg, kth)[kth:]
    if deg[hot_ids].sum() < COL_SPLIT_MIN_COVERAGE * len(col):
        return None
    hot_ids = np.sort(hot_ids)
    hot_map = np.full(num_cols, -1, np.int64)
    hot_map[hot_ids] = np.arange(hot_rows)
    m = hot_map[col]
    grp = (m < 0).astype(np.int8)
    col2 = np.where(m < 0, col, m)
    return grp, col2, hot_ids.astype(np.int32)


@dataclass(frozen=True)
class CsrBlock:
    """Edges ``[e0, e1)`` of an operator's layout-ordered edge arrays, in
    row order.  ``rowptr`` [rows+1] int32 holds offsets local to the block
    for rows ``row0 .. row0 + rows - 1``, ``split`` its plan of cut rows."""

    row0: int
    rowptr: torch.Tensor
    e0: int
    e1: int
    split: Optional[RowSplit] = None


@dataclass(frozen=True)
class CsrLayout:
    """One direction of an operator on the kernel tier.

    ``col`` [nnz] int32 in layout order (hot columns remapped into
    ``x[hot_ids]``).  Flat layouts have ``rowptr`` [N+1] (and its plan
    of cut rows ``row_split``) and no blocks; split or streamed ones have
    ``blocks``, of which the first ``hot_blocks`` gather from
    ``x[hot_ids]``."""

    col: torch.Tensor
    rowptr: Optional[torch.Tensor]
    blocks: Tuple[CsrBlock, ...] = ()
    hot_blocks: int = 0
    hot_ids: Optional[torch.Tensor] = None
    streamed: bool = False
    row_split: Optional[RowSplit] = None


def rowptr_of(row: torch.Tensor, n_rows: int) -> torch.Tensor:
    """[n_rows+1] int32 offsets of row-sorted ``row``."""
    counts = torch.bincount(row, minlength=n_rows)
    zero = torch.zeros(1, dtype=counts.dtype, device=row.device)
    return torch.cat([zero, counts.cumsum(0)]).to(torch.int32)


def _even_bounds(n: int, cap: int) -> np.ndarray:
    """Bounds of ceil(n / cap) blocks of near-equal size, as
    ``np.array_split`` cuts them."""
    k = max(1, -(-n // cap))
    q, rem = divmod(n, k)
    return np.concatenate([[0], np.cumsum([q + 1] * rem + [q] * (k - rem))])


def build_layout(row: np.ndarray, col: np.ndarray, n_rows: int, n_cols: int,
                 device, col_split: bool = True, stream: bool = True):
    """Lay out host edges ``(row, col)`` for the kernel tier on ``device``,
    split and streamed as this module's knobs say when it is called.
    ``col_split=False`` or ``stream=False`` rule out the split or the
    stream (the shards of parallel/mxu_shard.py: one CSR each, unsplit for
    trainable values).

    Returns (CsrLayout, perm) with ``perm`` [nnz] int64 on ``device``
    mapping layout order to input edge order (to permute edge values).
    Sorts are stable: edges that share a row (and section) keep their
    input order.  The call is the span ``pgsd.prep.layout``."""
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    nnz = len(row)
    if nnz >= 2 ** 31:
        raise ValueError(f"nnz={nnz} does not fit int32 offsets")
    streamed = stream and nnz > STREAM_THRESHOLD_EDGES
    with span("prep.layout", rows=n_rows, nnz=nnz, streamed=int(streamed)):
        return _layout(row, col, n_rows, n_cols, device, col_split,
                       streamed)


def _layout(row, col, n_rows, n_cols, device, col_split, streamed):
    """``build_layout``'s work on int64 host edges."""
    nnz = len(row)
    r = torch.from_numpy(row).to(device)
    split = col_degree_split(col, n_cols) if col_split else None
    hot_ids, n_hot, key = None, 0, r
    if split is not None:
        grp, col, hot = split
        hot_ids = torch.from_numpy(hot.astype(np.int64)).to(device)
        n_hot = int(np.count_nonzero(grp == 0))
        # hot section first, rows in order within each section
        key = torch.from_numpy(grp.astype(np.int64) * max(n_rows, 1)
                               + row).to(device)
    perm = torch.argsort(key, stable=True)
    c = torch.from_numpy(col).to(device)[perm].to(torch.int32)
    if split is None and not streamed:
        rp = rowptr_of(r, n_rows)
        return CsrLayout(col=c, rowptr=rp, row_split=plan_row_split(rp)), \
            perm

    rows = r[perm]
    sections = ((0, n_hot), (n_hot, nnz)) if split is not None else \
        ((0, nnz),)
    blocks, hot_blocks = [], 0
    for k, (s0, s1) in enumerate(sections):
        if s1 == s0:
            continue
        rp = rowptr_of(rows[s0:s1], n_rows)
        if not streamed:
            new = [CsrBlock(0, rp, s0, s1, plan_row_split(rp))]
        else:
            b = _even_bounds(s1 - s0, STREAM_BLOCK_EDGES)
            # the rows of each block's first and last edge, in one fetch
            ends = torch.from_numpy(np.stack([b[:-1], b[1:] - 1], 1) + s0)
            first_last = rows[ends.to(device)].cpu().numpy()
            new = []
            for (a, z), (r0, r1) in zip(zip(b[:-1], b[1:]), first_last):
                local = (rp[r0:r1 + 2] - int(a)).clamp_(0, int(z - a))
                local = local.to(torch.int32)
                new.append(CsrBlock(int(r0), local, s0 + int(a), s0 + int(z),
                                    plan_row_split(local)))
        if split is not None and k == 0:
            hot_blocks = len(new)
        blocks += new
    return CsrLayout(col=c, rowptr=None, blocks=tuple(blocks),
                     hot_blocks=hot_blocks, hot_ids=hot_ids,
                     streamed=streamed), perm
