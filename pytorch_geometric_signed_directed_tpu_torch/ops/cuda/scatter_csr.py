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
order.  Which rows are cut, and where, is a ``RowSplit`` plan of the
rowptr (``plan_row_split``): ``ops/layout.py`` builds it once per CSR,
beside the rowptr, and every entry takes it as ``split``.  Given none, an
entry plans the rowptr itself, which costs a host sync per call.

Each entry has its plain PyTorch version beside it.  A wrapper takes the
plain version only for tensors on the CPU (which need no plan); for CUDA
tensors it launches the kernel or raises.  ``LAUNCHES`` counts calls that
launched, one per call, whether the call made one device launch or two
(the second when a row is cut).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from . import build

LAUNCHES: Dict[str, int] = {"csr_dual_spmm": 0, "csr_scatter_sum": 0,
                            "csr_dual_spmm_accum": 0,
                            "csr_scatter_accum": 0, "csr_pair_spmm": 0,
                            "csr_pair_spmm_accum": 0}

# Longest row that one thread group sums alone; longer rows are cut into
# pieces of this many edges.  A piece's chain of dependent loads is about
# PIECE_EDGES / 8 memory latencies (the kernels keep 8 gathers in flight),
# some 60 us from device memory.
PIECE_EDGES = 1024

_SOURCE = "scatter_csr.cu"
_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures on a loaded build of the source."""
    p, i = ctypes.c_void_p, ctypes.c_int
    plan = [p, i, p, p, i, i, p]
    lib.pgsd_csr_dual_spmm.restype = i
    lib.pgsd_csr_dual_spmm.argtypes = [p] * 6 + [i] * 6 + plan + [p]
    lib.pgsd_csr_pair_spmm.restype = i
    lib.pgsd_csr_pair_spmm.argtypes = [p] * 8 + [i] * 6 + plan + [p]
    lib.pgsd_csr_scatter.restype = i
    lib.pgsd_csr_scatter.argtypes = [p, p, p] + [i] * 7 + plan + [p]
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
    """Rows of one CSR cut into pieces.

    ``rows`` [R] int32 are the cut rows in order; the pieces of ``rows[j]``
    are ``pieces[ptr[j]:ptr[j+1]]`` ([P, 2] int32 of (first edge, end
    edge), offsets of the rowptr the plan was made from), in edge order,
    each of at most ``piece_len`` edges.  Only the row's last piece may be
    shorter."""

    piece_len: int
    rows: torch.Tensor
    ptr: torch.Tensor
    pieces: torch.Tensor

    def __post_init__(self):
        # checked once here, so that a launch only checks the device
        for name in ("rows", "ptr", "pieces"):
            t = getattr(self, name)
            if t.dtype != torch.int32 or not t.is_contiguous():
                raise TypeError(f"RowSplit.{name} must be contiguous int32")
            if t.device != self.rows.device:
                raise ValueError("RowSplit tensors must share a device")
        if self.rows.dim() != 1 or \
                self.ptr.shape != (self.rows.numel() + 1,) or \
                self.pieces.dim() != 2 or self.pieces.shape[1] != 2:
            raise ValueError("RowSplit needs rows [R], ptr [R+1] and "
                             "pieces [P, 2]")
        if self.piece_len < 1:
            raise ValueError(f"piece_len={self.piece_len} must be positive")

    def launch_args(self, width: int):
        """The C arguments of the plan, and the float64 partials' scratch
        they point at (None when no row is cut); the caller keeps the
        scratch alive until the launch is enqueued."""
        n_pieces = self.pieces.shape[0]
        partial = None
        if n_pieces:
            partial = torch.empty((n_pieces, width), dtype=torch.float64,
                                  device=self.pieces.device)
        return [self.pieces.data_ptr(), n_pieces, self.rows.data_ptr(),
                self.ptr.data_ptr(), self.rows.numel(), self.piece_len,
                0 if partial is None else partial.data_ptr()], partial


def plan_row_split(rowptr: torch.Tensor, piece_len: int = PIECE_EDGES,
                   min_len: Optional[int] = None) -> RowSplit:
    """Cut the rows of ``rowptr`` longer than ``min_len`` edges (by
    default ``piece_len``, the CSR kernels' rule) into pieces of
    ``piece_len`` edges.  ``min_len=-1`` lists every row, an empty one
    with no pieces (the BSR kernel's rule).  Tensor ops on rowptr's
    device, with one host sync for the piece count."""
    if piece_len < 1:
        raise ValueError(f"piece_len={piece_len} must be positive")
    min_len = piece_len if min_len is None else min_len
    rp = rowptr.long()
    length = rp[1:] - rp[:-1]
    rows = torch.nonzero(length > min_len).flatten()
    counts = (length[rows] + piece_len - 1) // piece_len
    ptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    owner = torch.repeat_interleave(
        torch.arange(rows.numel(), device=rp.device), counts)
    first = (rp[rows][owner]
             + (torch.arange(owner.numel(), device=rp.device) - ptr[owner])
             * piece_len)
    end = torch.minimum(first + piece_len, rp[rows + 1][owner])
    return RowSplit(piece_len=piece_len, rows=rows.to(torch.int32),
                    ptr=ptr.to(torch.int32),
                    pieces=torch.stack([first, end], 1).to(torch.int32))


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


def _plan_args(rowptr, split: Optional[RowSplit], width: int, device):
    """The plan's launch arguments and their scratch (see
    RowSplit.launch_args), planning rowptr when ``split`` is None."""
    if split is None:
        split = plan_row_split(rowptr)
    _check_split(split, device)
    return split.launch_args(width)


def _stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


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
    plan, _partial = _plan_args(rowptr, split, wo, dev)
    with torch.cuda.device(dev):
        err = getattr(_library(), "pgsd_" + entry)(
            rowptr.data_ptr(), col.data_ptr(), *(v.data_ptr() for v in vals),
            x.data_ptr(), out.data_ptr(), n, w, fa,
            int(x.dtype == torch.bfloat16), int(accum), row0, *plan,
            _stream_ptr(dev))
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
    """``(V, TL)`` of ``pgsd_csr_scatter`` for these messages: each thread
    sums V neighbouring lanes of every P-th edge of a row, P = min(32 / TL,
    MSG_SLOTS), with TL threads across a lane tile of TL * V lanes (tiles
    past it go to blockIdx.y).  V is 16 bytes of the message type (4
    float32, 8 bfloat16) when every message row starts 16-byte aligned,
    else 1."""
    w = msgs.shape[1]
    v = 16 // msgs.element_size()
    if w % v or msgs.data_ptr() % 16:
        v = 1
    chunks = -(-w // v)
    return v, min(32, 1 << (chunks - 1).bit_length())


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
    plan, _partial = _plan_args(rowptr, split, w, dev)
    with torch.cuda.device(dev):
        err = _library().pgsd_csr_scatter(
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


def csr_scatter_sum(rowptr: torch.Tensor, msgs: torch.Tensor,
                    split: Optional[RowSplit] = None) -> torch.Tensor:
    """Segment sum of row-ordered messages ``msgs [E, F]`` (float32 or
    bfloat16) into float32 ``[N, F]``; rows without edges are 0."""
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
