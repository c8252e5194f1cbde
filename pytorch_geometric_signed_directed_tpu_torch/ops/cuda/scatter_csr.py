"""CSR segment sums on the card — the port of the TPU kernels K1 and K2.

Counterpart of ``pytorch_geometric_signed_directed_tpu/ops/pallas/
scatter_mxu.py``: K1 (``_kernel`` / ``_scatter_matmul`` behind
``scatter_sum``) and K2 (``_kernel_accum`` / ``_scatter_accum``, which
accumulates into an output that already holds values).  The TPU kernels
lay edges out in windows and chunks and sum them with one-hot matmuls;
here the layout is plain CSR (``rowptr`` int32 with edges in row order)
and the kernels in ``csrc/scatter_csr.cu`` are a row-sorted
gather-multiply-reduce.  The ``*_accum`` entries (K2) add into ``out``
in place, at rows ``row0 + r``, and leave rows without edges alone.

``csr_pair_spmm`` is K1 on the trainable-q pair forward: the TPU builds
``[E, 4F]`` messages outside its kernel (its row gather is row-rate-bound)
and scatters them with K1; here one kernel gathers ``x`` itself and keeps
both sums of a lane, so no message tensor is written.

Rows longer than ``PIECE_EDGES`` edges are cut into pieces that run in
parallel, and a second launch adds each cut row's pieces in a fixed
order; where most rows are short, they are grouped into row blocks of
fewer than ``BLOCK_EDGES`` edges and at most ``BLOCK_ROWS`` rows, one
warp a block.  Which rows are cut, and
where, and how the others are grouped, is a ``RowSplit`` plan of the
rowptr (``plan_row_split``): ``ops/layout.py`` builds it once per CSR,
beside the rowptr, and every entry takes it as ``split``.  Given none, an
entry plans the rowptr itself, which costs a host sync per call, and
raises while a CUDA graph is being captured.

Each entry has its plain PyTorch version beside it.  A wrapper takes the
plain version only for tensors on the CPU (which need no plan); for CUDA
tensors it launches the kernel or raises.  ``LAUNCHES`` counts calls that
launched, one per call, whether the call made one device launch or two
(the second when a row is cut); each such call is also the span
``pgsd.kernel.<wrapper>`` (``instrument``).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ...instrument import counter, span
from . import build

# csr_scatter_sum_indexed counts the calls of csr_scatter_sum that read
# their messages by index; csr_scatter_sum counts them too
LAUNCHES = counter("kernels", (
    "csr_dual_spmm", "csr_scatter_sum", "csr_dual_spmm_accum",
    "csr_scatter_accum", "csr_pair_spmm", "csr_pair_spmm_accum",
    "csr_scatter_sum_indexed"))

# Longest row that one thread group sums alone; longer rows are cut into
# pieces of this many edges.  A piece's chain of dependent loads is about
# PIECE_EDGES / 8 memory latencies (the kernels keep 8 gathers in flight),
# some 60 us from device memory.
PIECE_EDGES = 1024

# Row blocks (CSR-Adaptive's): runs of consecutive short uncut rows (at
# most BLOCK_EDGES // 2 edges each) holding fewer than BLOCK_EDGES edges
# and at most BLOCK_ROWS rows, each of which one warp sums in about three
# memory latencies (csrc/scatter_csr.cu, "Short rows"; the source's
# kBlockEdges and kBlockRows, which bind() holds these to).
BLOCK_EDGES = 32
BLOCK_ROWS = 32
# Uncut rows of more than WALK_EDGES edges are also listed on their own
# (``RowSplit.walks``): at message widths off a multiple of 4 a warp
# walks each of them, where a shorter row takes a thread a column (the
# source's kWalkEdges, which bind() holds this to).
WALK_EDGES = 64
# Above BLOCK_TILE (32) lanes the dual sums the row blocks in tiles of
# BLOCK_TILE lanes, a warp a tile of a block, only where x (the gathered
# table) is more than WIDE_BLOCK_L2 times the card's L2: there the
# gathers come from device memory, and a block's copies all in flight at
# once beat the walk's short chains (giant cold blocks at 2F=64: 17-24%
# faster); from an L2-resident table the walk of a row a warp won (the
# hot blocks 8% at f32, the bench SGCN dual at 2F=128 39%; timed on an
# H100 with scripts/ab_kernel_variants.py, PERF.md).  The source's kTile,
# which bind() holds this to.
BLOCK_TILE = 32
WIDE_BLOCK_L2 = 2

_SOURCE = "scatter_csr.cu"
_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures on a loaded build of the source, and check that
    it takes the row blocks and walked rows that plan_row_split makes."""
    p, i = ctypes.c_void_p, ctypes.c_int
    plan = [p, i, p, p, i, i, p, p, i, p, i, p, i]
    lib.pgsd_csr_dual_spmm.restype = i
    lib.pgsd_csr_dual_spmm.argtypes = [p] * 6 + [i] * 7 + plan + [p]
    lib.pgsd_csr_pair_spmm.restype = i
    lib.pgsd_csr_pair_spmm.argtypes = [p] * 8 + [i] * 6 + plan + [p]
    lib.pgsd_csr_scatter.restype = i
    lib.pgsd_csr_scatter.argtypes = [p, p, p] + [i] * 7 + plan + [p]
    lib.pgsd_csr_scatter_indexed.restype = i
    lib.pgsd_csr_scatter_indexed.argtypes = [p] * 6 + [i] * 4 + plan + [p]
    edges, rows, walk = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib.pgsd_csr_block_shape(ctypes.byref(edges), ctypes.byref(rows),
                             ctypes.byref(walk))
    if (edges.value, rows.value, walk.value) != (BLOCK_EDGES, BLOCK_ROWS,
                                                 WALK_EDGES):
        raise RuntimeError(
            f"{_SOURCE} takes row blocks of {edges.value} edges and "
            f"{rows.value} rows and walks rows of more than {walk.value} "
            f"edges; scatter_csr.py plans {BLOCK_EDGES}, {BLOCK_ROWS} and "
            f"{WALK_EDGES}")
    if lib.pgsd_csr_dual_tile() != BLOCK_TILE:
        raise RuntimeError(f"{_SOURCE} tiles row blocks by "
                           f"{lib.pgsd_csr_dual_tile()} lanes; "
                           f"scatter_csr.py by {BLOCK_TILE}")
    return lib


def _library():
    global _lib
    if _lib is None:
        _lib = bind(build.load(_SOURCE))
    return _lib


def _row_ids(rowptr: torch.Tensor) -> torch.Tensor:
    n = rowptr.numel() - 1
    counts = (rowptr[1:] - rowptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(n, device=rowptr.device), counts)


# ---------------------------------------------------------------------------
# The plan of the cut rows


@dataclass(frozen=True)
class RowSplit:
    """Rows of one CSR cut into pieces, and the others grouped.

    ``rows`` [R] int32 are the cut rows in order; the pieces of ``rows[j]``
    are ``pieces[ptr[j]:ptr[j+1]]`` ([P, 2] int32 of (first edge, end
    edge), offsets of the rowptr the plan was made from), in edge order,
    each of at most ``piece_len`` edges.  Only the row's last piece may be
    shorter.  Short uncut rows (at most ``BLOCK_EDGES // 2`` edges) lie in
    ``blocks`` ([B, 4] int32 of (first row, end row, first edge, end
    edge), in row order): runs of consecutive rows, each row whole, of
    fewer than ``BLOCK_EDGES`` edges and at most ``BLOCK_ROWS`` rows.
    ``mids`` [M] int32 are the other uncut rows, in order, and ``walks``
    [K] int32 those of them of more than ``WALK_EDGES`` edges."""

    piece_len: int
    rows: torch.Tensor
    ptr: torch.Tensor
    pieces: torch.Tensor
    blocks: torch.Tensor
    mids: torch.Tensor
    walks: torch.Tensor

    def __post_init__(self):
        # checked once here, so that a launch only checks the device
        for name in ("rows", "ptr", "pieces", "blocks", "mids", "walks"):
            t = getattr(self, name)
            if t.dtype != torch.int32 or not t.is_contiguous():
                raise TypeError(f"RowSplit.{name} must be contiguous int32")
            if t.device != self.rows.device:
                raise ValueError("RowSplit tensors must share a device")
        if self.rows.dim() != 1 or \
                self.ptr.shape != (self.rows.numel() + 1,) or \
                self.pieces.dim() != 2 or self.pieces.shape[1] != 2 or \
                self.blocks.dim() != 2 or self.blocks.shape[1] != 4 or \
                self.mids.dim() != 1 or self.walks.dim() != 1:
            raise ValueError("RowSplit needs rows [R], ptr [R+1], pieces "
                             "[P, 2], blocks [B, 4], mids [M] and walks "
                             "[K]")
        if self.piece_len < 1:
            raise ValueError(f"piece_len={self.piece_len} must be positive")

    def _pointers(self):
        """The plan's C arguments that do not change: its tensors' device
        pointers and counts, read once (a call's host work is most of a
        short kernel's time)."""
        args = self.__dict__.get("_args")
        if args is None:
            args = (self.pieces.data_ptr(), self.pieces.shape[0],
                    self.rows.data_ptr(), self.ptr.data_ptr(),
                    self.rows.numel(), self.piece_len,
                    self.blocks.data_ptr(), self.blocks.shape[0],
                    self.mids.data_ptr(), self.mids.numel(),
                    self.walks.data_ptr(), self.walks.numel())
            object.__setattr__(self, "_args", args)
        return args

    def launch_args(self, width: int):
        """The C arguments of the cut rows, and the float64 partials'
        scratch they point at (None when no row is cut); the caller keeps
        the scratch alive until the launch is enqueued."""
        n_pieces = self.pieces.shape[0]
        partial = None
        if n_pieces:
            partial = torch.empty((n_pieces, width), dtype=torch.float64,
                                  device=self.pieces.device)
        return [*self._pointers()[:6],
                0 if partial is None else partial.data_ptr()], partial

    def block_args(self):
        """The C arguments of the row blocks, the mid rows and the walked
        rows."""
        return list(self._pointers()[6:])


def _positions(mask: torch.Tensor, count: int) -> torch.Tensor:
    """The indices of ``mask``'s ``count`` True entries, in order, without
    a host sync (a scatter by the running count)."""
    slot = torch.cumsum(mask, 0) - 1
    out = torch.zeros(count + 1, dtype=torch.long, device=mask.device)
    out.scatter_(0, torch.where(mask, slot, count),
                 torch.arange(mask.numel(), device=mask.device))
    return out[:count]


def plan_row_split(rowptr: torch.Tensor, piece_len: int = PIECE_EDGES,
                   min_len: Optional[int] = None) -> RowSplit:
    """Cut the rows of ``rowptr`` longer than ``min_len`` edges (by
    default ``piece_len``, the CSR kernels' rule) into pieces of
    ``piece_len`` edges, and group the short uncut rows into row blocks.
    ``min_len=-1`` lists every row, an empty one with no pieces (the BSR
    kernel's rule), and leaves no block.

    A row block is a run of consecutive rows of at most ``BLOCK_EDGES //
    2`` edges that start in the same window of ``BLOCK_EDGES // 2`` edges
    and the same window of ``BLOCK_ROWS`` rows, so that it holds fewer
    than ``BLOCK_EDGES`` edges.  The other uncut rows are mid rows, which
    a thread group each sums.  Blocks are made only where such short rows
    are at least half of the uncut rows: elsewhere every uncut row is a mid
    row (a few blocks would cost the whole launch the block path's shared
    memory).  The uncut rows of more than ``WALK_EDGES`` edges are listed
    again as walks.  Tensor ops on rowptr's device, with one host read of
    the counts."""
    if piece_len < 1:
        raise ValueError(f"piece_len={piece_len} must be positive")
    if rowptr.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "a kernel wrapper was given no plan (split=) while a CUDA graph "
            "is being captured: planning reads the piece count on the host, "
            "which capture forbids.  Pass the operator's plan, which "
            "ops/layout.py builds once per CSR")
    min_len = piece_len if min_len is None else min_len
    dev = rowptr.device
    rp = rowptr.long()
    length = rp[1:] - rp[:-1]
    n = length.numel()
    cut = length > min_len
    counts = torch.where(cut, (length + piece_len - 1) // piece_len, 0)
    half = BLOCK_EDGES // 2
    short = ~cut & (length <= half)
    ids = torch.arange(n, device=dev)
    # row r + 1 continues row r's block
    joined = (short[1:] & short[:-1]
              & (rp[1:-1] // half == rp[:-2] // half)
              & (ids[1:] // BLOCK_ROWS == ids[:-1] // BLOCK_ROWS))
    no = joined.new_zeros(1)
    first = short & ~torch.cat([no, joined])
    last = short & ~torch.cat([joined, no])
    walk = ~cut & (length > WALK_EDGES)
    n_long, n_pieces, n_blocks, n_short, n_uncut, n_walks = torch.stack(
        [cut.sum(), counts.sum(), first.sum(), short.sum(),
         (~cut).sum(), walk.sum()]).tolist()
    if 2 * n_short < n_uncut:
        short, n_blocks = torch.zeros_like(short), 0
        first = last = short
    mid = ~cut & ~short
    rows = _positions(cut, n_long)
    counts = counts[rows]
    ptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    owner = torch.repeat_interleave(
        torch.arange(n_long, device=dev), counts, output_size=n_pieces)
    start = (rp[rows][owner]
             + (torch.arange(n_pieces, device=dev) - ptr[owner]) * piece_len)
    end = torch.minimum(start + piece_len, rp[rows + 1][owner])
    r0 = _positions(first, n_blocks)
    r1 = _positions(last, n_blocks) + 1
    i32 = torch.int32
    return RowSplit(
        piece_len=piece_len, rows=rows.to(i32), ptr=ptr.to(i32),
        pieces=torch.stack([start, end], 1).to(i32),
        blocks=torch.stack([r0, r1, rp[r0], rp[r1]], 1).to(i32),
        mids=_positions(mid, n_uncut - (n_short if n_blocks else 0)).to(i32),
        walks=_positions(walk, n_walks).to(i32))


# ---------------------------------------------------------------------------
# Checks and launch arguments


def _check(name: str, t: torch.Tensor, dtypes, ndim: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                        f"{dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_rowptr(rowptr: torch.Tensor, nnz: int, device) -> int:
    _check("rowptr", rowptr, (torch.int32,), 1, device)
    if rowptr.numel() < 1:
        raise ValueError("rowptr needs at least one entry")
    if nnz >= 2 ** 31:
        raise ValueError(f"nnz={nnz} does not fit the kernel's int32 "
                         f"edge offsets")
    return rowptr.numel() - 1


def _check_split(split: RowSplit, device) -> None:
    if split.rows.device != device:
        raise ValueError(f"split is on {split.rows.device}, expected "
                         f"{device}")


def _plan_args(rowptr, split: Optional[RowSplit], width: int, device,
               blocks: bool = False):
    """The plan's launch arguments and their scratch (see
    RowSplit.launch_args; with ``blocks``, its block_args too), planning
    rowptr when ``split`` is None."""
    if split is None:
        split = plan_row_split(rowptr)
    _check_split(split, device)
    args, partial = split.launch_args(width)
    return (args + split.block_args() if blocks else args), partial


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream_ptr(device) -> int:
    """The pointer of ``device``'s current CUDA stream (PyTorch's raw
    accessor where it has one: a Stream object costs microseconds)."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def _on(device, fn, *args) -> int:
    """``fn(*args)`` with ``device`` current: a kernel launches on the
    current device.  The device guard is entered only when it is another
    device than the current one."""
    if device.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)


_L2_BYTES: Dict[int, int] = {}


def _wide_blocks(x: torch.Tensor) -> int:
    """1 where the dual takes row blocks above BLOCK_TILE lanes: x more
    than WIDE_BLOCK_L2 times the L2 of its card (read once a device).
    The kernel reads it only above BLOCK_TILE lanes."""
    dev = x.device.index
    if dev not in _L2_BYTES:
        _L2_BYTES[dev] = torch.cuda.get_device_properties(dev).L2_cache_size
    return int(x.numel() * x.element_size() > WIDE_BLOCK_L2 * _L2_BYTES[dev])


def _add_rows_(out, rowptr, msgs, row0: int = 0) -> torch.Tensor:
    """``out[row0 + r] += sum of row r's messages`` in place, summed in
    float64 and rounded once to float32: the exact sum that the kernels'
    compensated float32 sums approach to a few ulp."""
    acc = out.double().index_add_(0, _row_ids(rowptr) + row0, msgs.double())
    return out.copy_(acc)


def _check_out(out: torch.Tensor, row0: int, n: int, w: int, device):
    _check("out", out, (torch.float32,), 2, device)
    if out.shape[1] != w:
        raise ValueError(f"out has width {out.shape[1]}, expected {w}")
    if row0 < 0 or row0 + n > out.shape[0]:
        raise ValueError(f"rows [{row0}, {row0 + n}) outside out's "
                         f"{out.shape[0]} rows")


def _cuda_device(name: str, t: torch.Tensor):
    if t.device.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {t.device}")
    return t.device


# ---------------------------------------------------------------------------
# csr_dual_spmm: gather x, multiply by the lane-selected value, segment-sum


def _dual_msgs(col, val_a, val_b, x, fa: int) -> torch.Tensor:
    """``round(val_sel * x[col])`` in float32: the product rounded to x's
    type, as the kernels round it."""
    lane = torch.arange(x.shape[1], device=x.device) < fa
    sel = torch.where(lane[None, :], val_a[:, None], val_b[:, None])
    return (sel * x[col.long()].float()).to(x.dtype).float()


def csr_dual_spmm_plain(rowptr, col, val_a, val_b, x, fa: int):
    """Plain PyTorch version of ``csr_dual_spmm``: ``index_add_`` over
    ``round(val_sel * x[col])`` with the same message rounding."""
    out = torch.zeros((rowptr.numel() - 1, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    return _add_rows_(out, rowptr, _dual_msgs(col, val_a, val_b, x, fa))


_VALUE_NAMES = ("val_a", "val_b", "w_a", "w_b")


def _edge_launch(name, entry, rowptr, col, vals, x, fa, out, row0, split):
    """Launch ``pgsd_<entry>`` with per-edge ``vals`` (two for the dual, four
    for the pair; ``out`` None: the plain mode, into a new output); returns
    the output, ``len(vals) // 2`` times x's width wide."""
    dev = _cuda_device(name, x)
    _check("x", x, (torch.float32, torch.bfloat16), 2, dev)
    _check("col", col, (torch.int32,), 1, dev)
    for k, v in zip(_VALUE_NAMES, vals):
        _check(k, v, (torch.float32,), 1, dev)
    nnz = col.numel()
    if any(v.numel() != nnz for v in vals):
        raise ValueError("col and the per-edge values must have one entry "
                         "per edge")
    n = _check_rowptr(rowptr, nnz, dev)
    w = x.shape[1]
    wo = len(vals) // 2 * w
    if not 0 <= fa <= w:
        raise ValueError(f"fa={fa} outside [0, {w}]")
    accum = out is not None
    if accum:
        _check_out(out, row0, n, wo, dev)
    if n == 0 or w == 0:
        return out if accum else torch.zeros((n, wo), dtype=torch.float32,
                                             device=dev)
    if not accum:
        out = torch.empty((n, wo), dtype=torch.float32, device=dev)
    with span("kernel." + name, rows=n, nnz=nnz, width=wo):
        plan, _partial = _plan_args(rowptr, split, wo, dev, blocks=True)
        wide = (_wide_blocks(x),) if entry == "csr_dual_spmm" else ()
        err = _on(dev, getattr(_library(), "pgsd_" + entry),
                  rowptr.data_ptr(), col.data_ptr(),
                  *(v.data_ptr() for v in vals), x.data_ptr(),
                  out.data_ptr(), n, w, fa, int(x.dtype == torch.bfloat16),
                  int(accum), row0, *wide, *plan, _stream_ptr(dev))
        if err:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        LAUNCHES[name] += 1
    return out


def csr_dual_spmm(rowptr: torch.Tensor, col: torch.Tensor,
                  val_a: torch.Tensor, val_b: torch.Tensor, x: torch.Tensor,
                  fa: int, split: Optional[RowSplit] = None) -> torch.Tensor:
    """``out[r, l] = sum_{e in [rowptr[r], rowptr[r+1])} m[e, l]`` with
    ``m[e, l] = round((l < fa ? val_a[e] : val_b[e]) * x[col[e], l])``.

    ``x`` [M, W] is float32 or bfloat16; messages round to x's type and
    sum in float32.  Returns float32 [N, W]; rows without edges are 0.
    ``col`` must index rows of ``x`` (the builders check it once);
    ``split`` is rowptr's plan (``plan_row_split``).  The kernel is
    deterministic: each row sums its edges, or its pieces, in order."""
    if x.device.type == "cpu":
        return csr_dual_spmm_plain(rowptr, col, val_a, val_b, x, fa)
    return _edge_launch("csr_dual_spmm", "csr_dual_spmm", rowptr, col,
                        (val_a, val_b), x, fa, None, 0, split)


def csr_dual_spmm_accum_plain(rowptr, col, val_a, val_b, x, fa: int, out,
                              row0: int = 0):
    """Plain PyTorch version of ``csr_dual_spmm_accum``: ``index_add_``
    into a clone of ``out`` (``out`` itself is left as it is)."""
    return _add_rows_(out.clone(), rowptr,
                      _dual_msgs(col, val_a, val_b, x, fa), row0)


def csr_dual_spmm_accum(rowptr: torch.Tensor, col: torch.Tensor,
                        val_a: torch.Tensor, val_b: torch.Tensor,
                        x: torch.Tensor, fa: int, out: torch.Tensor,
                        row0: int = 0,
                        split: Optional[RowSplit] = None) -> torch.Tensor:
    """``out[row0 + r, l] += sum_{e in [rowptr[r], rowptr[r+1])} m[e, l]``
    in place, with ``m`` as in ``csr_dual_spmm``; returns ``out``.

    One block of a split or streamed layout: ``rowptr`` is local to the
    block's edges (and ``split`` its plan).  Each row sums from its prior
    value, and rows without edges are not written."""
    if x.device.type == "cpu":
        return _add_rows_(out, rowptr,
                          _dual_msgs(col, val_a, val_b, x, fa), row0)
    return _edge_launch("csr_dual_spmm_accum", "csr_dual_spmm", rowptr, col,
                        (val_a, val_b), x, fa, out, row0, split)


# ---------------------------------------------------------------------------
# csr_pair_spmm: the trainable-q pair forward, two value pairs and two sums


def _pair_msgs(col, val_a, val_b, w_a, w_b, x, fa: int) -> torch.Tensor:
    """``[round(val_sel * x[col]) | round(w_sel * x[col])]`` in float32,
    [E, 2W]."""
    return torch.cat([_dual_msgs(col, val_a, val_b, x, fa),
                      _dual_msgs(col, w_a, w_b, x, fa)], 1)


def csr_pair_spmm_plain(rowptr, col, val_a, val_b, w_a, w_b, x, fa: int):
    """Plain PyTorch version of ``csr_pair_spmm``: ``index_add_`` over the
    [E, 2W] messages with the kernel's rounding."""
    out = torch.zeros((rowptr.numel() - 1, 2 * x.shape[1]),
                      dtype=torch.float32, device=x.device)
    return _add_rows_(out, rowptr,
                      _pair_msgs(col, val_a, val_b, w_a, w_b, x, fa))


def csr_pair_spmm(rowptr: torch.Tensor, col: torch.Tensor,
                  val_a: torch.Tensor, val_b: torch.Tensor,
                  w_a: torch.Tensor, w_b: torch.Tensor, x: torch.Tensor,
                  fa: int, split: Optional[RowSplit] = None) -> torch.Tensor:
    """Two segment sums of one gather: float32 ``[N, 2W]`` with

        out[r, l]     = sum_e round((l < fa ? val_a : val_b)[e] * x[col[e], l])
        out[r, W + l] = sum_e round((l < fa ? w_a : w_b)[e] * x[col[e], l])

    for ``l < W``, the width of ``x`` (float32 or bfloat16; both products
    round to its type and sum in float32).  It is ``csr_scatter_sum`` over
    the [E, 2W] messages ``[val_sel * x[col] | w_sel * x[col]]`` without
    the messages.  Rows without edges are 0; ``split`` is rowptr's plan.
    Deterministic, as ``csr_dual_spmm``."""
    if x.device.type == "cpu":
        return csr_pair_spmm_plain(rowptr, col, val_a, val_b, w_a, w_b, x, fa)
    return _edge_launch("csr_pair_spmm", "csr_pair_spmm", rowptr, col,
                        (val_a, val_b, w_a, w_b), x, fa, None, 0, split)


def csr_pair_spmm_accum_plain(rowptr, col, val_a, val_b, w_a, w_b, x,
                              fa: int, out, row0: int = 0):
    """Plain PyTorch version of ``csr_pair_spmm_accum``: ``index_add_``
    into a clone of ``out``."""
    return _add_rows_(out.clone(), rowptr,
                      _pair_msgs(col, val_a, val_b, w_a, w_b, x, fa), row0)


def csr_pair_spmm_accum(rowptr: torch.Tensor, col: torch.Tensor,
                        val_a: torch.Tensor, val_b: torch.Tensor,
                        w_a: torch.Tensor, w_b: torch.Tensor, x: torch.Tensor,
                        fa: int, out: torch.Tensor, row0: int = 0,
                        split: Optional[RowSplit] = None) -> torch.Tensor:
    """``csr_pair_spmm`` of one block of a split or streamed layout, added
    in place into the float32 ``[*, 2W]`` ``out`` at rows ``row0 + r``
    (rows without edges are not written); returns ``out``."""
    if x.device.type == "cpu":
        return _add_rows_(out, rowptr,
                          _pair_msgs(col, val_a, val_b, w_a, w_b, x, fa),
                          row0)
    return _edge_launch("csr_pair_spmm_accum", "csr_pair_spmm", rowptr, col,
                        (val_a, val_b, w_a, w_b), x, fa, out, row0, split)


# ---------------------------------------------------------------------------
# csr_scatter_sum / csr_scatter_accum: segment sums of row-ordered messages


# The most edge slots a row gets in pgsd_csr_scatter (the kernel's
# msg_slots): a row takes TL * min(32 / TL, MSG_SLOTS) threads of a warp.
MSG_SLOTS = 8


def _msg_geometry(msgs: torch.Tensor):
    """``(V, TL)`` of ``pgsd_csr_scatter`` for these messages.  V is 16
    bytes of the message type (4 float32, 8 bfloat16) when every message
    row starts 16-byte aligned: each thread sums V neighbouring lanes of
    every P-th edge of a row, P = min(32 / TL, MSG_SLOTS), with TL threads
    across a lane tile of TL * V lanes (tiles past it go to blockIdx.y).
    Else V is 1, at any width: up to the kernel's kSpanWidth (36) lanes
    the row blocks are staged as contiguous spans with 16-byte copies, and
    the other rows are walked a thread a (row, column) pair, or a warp a
    row past WALK_EDGES edges; TL is not read."""
    w = msgs.shape[1]
    v = 16 // msgs.element_size()
    if w % v or msgs.data_ptr() % 16:
        return 1, 1
    return v, min(32, 1 << (w // v - 1).bit_length())


def _scatter_launch(name, rowptr, msgs, out, row0, split):
    dev = _cuda_device(name, msgs)
    _check("msgs", msgs, (torch.float32, torch.bfloat16), 2, dev)
    n = _check_rowptr(rowptr, msgs.shape[0], dev)
    w = msgs.shape[1]
    accum = out is not None
    if accum:
        _check_out(out, row0, n, w, dev)
    if n == 0 or w == 0:
        return out if accum else torch.zeros((n, w), dtype=torch.float32,
                                             device=dev)
    if not accum:
        out = torch.empty((n, w), dtype=torch.float32, device=dev)
    with span("kernel." + name, rows=n, nnz=msgs.shape[0], width=w,
              indexed=0):
        plan, _partial = _plan_args(rowptr, split, w, dev, blocks=True)
        err = _on(dev, _library().pgsd_csr_scatter,
                  rowptr.data_ptr(), msgs.data_ptr(), out.data_ptr(), n, w,
                  int(msgs.dtype == torch.bfloat16), int(accum), row0,
                  *_msg_geometry(msgs), *plan, _stream_ptr(dev))
        if err:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        LAUNCHES[name] += 1
    return out


def csr_scatter_sum_plain(rowptr, msgs):
    """Plain PyTorch version of ``csr_scatter_sum`` (``index_add_``);
    float64 messages, which the kernel does not take, sum into float64."""
    n = rowptr.numel() - 1
    dtype = torch.float64 if msgs.dtype == torch.float64 else torch.float32
    out = torch.zeros((n, msgs.shape[1]), dtype=dtype, device=msgs.device)
    return _add_rows_(out, rowptr, msgs)


def indexed_messages(table, index, weight=None,
                     scalar=None) -> torch.Tensor:
    """The messages ``csr_scatter_sum`` reads by index, materialized:
    ``[s | w[:, None] * table[index]]``; the message tensor the indexed
    sum never writes."""
    rows = table[index]
    if weight is not None:
        rows = rows * weight[:, None]
    if scalar is None:
        return rows
    return torch.cat([scalar[:, None], rows], 1)


def _indexed_launch(rowptr, table, index, weight, scalar, split):
    dev = _cuda_device("csr_scatter_sum", table)
    _check("table", table, (torch.float32,), 2, dev)
    _check("index", index, (torch.int64,), 1, dev)
    nnz = index.numel()
    for k, v in (("weight", weight), ("scalar", scalar)):
        if v is not None:
            _check(k, v, (torch.float32,), 1, dev)
            if v.numel() != nnz:
                raise ValueError(f"{k} needs one entry per message "
                                 f"({nnz}), got {v.numel()}")
    n = _check_rowptr(rowptr, nnz, dev)
    f = table.shape[1]
    w = f + (scalar is not None)
    if n == 0 or f == 0:
        return torch.zeros((n, w), dtype=torch.float32, device=dev)
    out = torch.empty((n, w), dtype=torch.float32, device=dev)
    with span("kernel.csr_scatter_sum", rows=n, nnz=nnz, width=w,
              indexed=1):
        plan, _partial = _plan_args(rowptr, split, w, dev, blocks=True)
        err = _on(dev, _library().pgsd_csr_scatter_indexed,
                  rowptr.data_ptr(), table.data_ptr(), index.data_ptr(),
                  *(0 if v is None else v.data_ptr()
                    for v in (weight, scalar)),
                  out.data_ptr(), n, f, *_msg_geometry(table), *plan,
                  _stream_ptr(dev))
        if err:
            raise RuntimeError(f"csr_scatter_sum launch failed: CUDA error "
                               f"{err}")
        LAUNCHES["csr_scatter_sum"] += 1
        LAUNCHES["csr_scatter_sum_indexed"] += 1
    return out


def csr_scatter_sum(rowptr: torch.Tensor, msgs: torch.Tensor,
                    split: Optional[RowSplit] = None, *,
                    index: Optional[torch.Tensor] = None,
                    weight: Optional[torch.Tensor] = None,
                    scalar: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Segment sum of row-ordered messages ``msgs [E, F]`` (float32 or
    bfloat16) into float32 ``[N, F]``; rows without edges are 0.

    Given ``index`` ([E] int64, in the CSR's slot order), ``msgs`` is a
    float32 table [M, F] and message j is ``[s_j | w_j * msgs[index[j]]]``
    (``indexed_messages``): ``weight`` w (else 1) and ``scalar`` s (else
    no scalar lane) are [E] float32 in the same slot order.  The kernel
    reads each message where it adds it, and its sums equal this sum over
    the materialized messages at the same geometry bit for bit; the call
    also counts in ``LAUNCHES["csr_scatter_sum_indexed"]``."""
    if index is not None:
        if msgs.device.type == "cpu":
            return csr_scatter_sum_plain(rowptr, indexed_messages(
                msgs, index, weight, scalar))
        return _indexed_launch(rowptr, msgs, index, weight, scalar, split)
    if msgs.device.type == "cpu":
        return csr_scatter_sum_plain(rowptr, msgs)
    return _scatter_launch("csr_scatter_sum", rowptr, msgs, None, 0, split)


def csr_scatter_accum_plain(rowptr, msgs, out, row0: int = 0):
    """Plain PyTorch version of ``csr_scatter_accum``: ``index_add_`` into
    a clone of ``out``."""
    return _add_rows_(out.clone(), rowptr, msgs, row0)


def csr_scatter_accum(rowptr: torch.Tensor, msgs: torch.Tensor,
                      out: torch.Tensor, row0: int = 0,
                      split: Optional[RowSplit] = None) -> torch.Tensor:
    """K2's own contract: ``out[row0 + r] += sum of the row-ordered
    messages of row r`` in place (float32 ``out``; ``msgs`` float32 or
    bfloat16); rows without messages are not written.  Returns ``out``."""
    if msgs.device.type == "cpu":
        return _add_rows_(out, rowptr, msgs, row0)
    return _scatter_launch("csr_scatter_accum", rowptr, msgs, out, row0,
                           split)
