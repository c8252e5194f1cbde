"""SpMM: sparse operator × dense features, the hot op of every GNN layer.

Counterpart of ``pytorch_geometric_signed_directed_tpu/ops/spmm.py``.  The
mode strings are the JAX package's, so both take the same arguments:

  * ``dense``    — the operator materialised once; ``torch.matmul``.
  * ``segment``  — gather + ``index_add_`` (ops.segment.segment_sum).
  * ``mxu``      — on the card, the tier of the hand-written CSR kernels
                   (ops/cuda/scatter_csr.cu, the port of the TPU kernels
                   K1 and K2 that the JAX package runs under this name).
                   Giant operators take the column-split and streamed
                   layouts of ops/layout.py, chosen as the JAX package
                   chooses them.  CPU tensors take the kernels' plain
                   PyTorch versions.
  * ``bsr``      — 128×128 dense blocks (ops/bsr.py) applied by the
                   hand-written block-sparse kernel
                   (ops/cuda/bsr_spmm.cu, the port of the TPU kernel K5).
  * ``auto``     — ``dense`` up to 8192 nodes, else ``mxu``.

Operators sharded by parallel/ (``shard_propagator``, ``shard_dual``)
carry their shards in ``sharded``: the kernel tier becomes
``mxu_sharded``, the dense, segment and bsr tiers keep their modes.  The
shards apply themselves (``sharded.apply``, ``sharded.forward_stacked``),
so this module imports nothing of parallel/.

Every tier is differentiable; on ``mxu`` the backward is the forward of
the transposed operator, built at preparation time.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..instrument import NO_SPAN, span, tracing
from .bsr import BSR, bsr_from_coo, bsr_spmm
from .coo import COO, build_coo, check_indices
from .cuda.scatter_csr import _row_ids, csr_dual_spmm, csr_dual_spmm_accum
from .cuda.scatter_csr import RowSplit
from .layout import CsrBlock, CsrLayout, build_layout
from .segment import segment_sum

# Graphs at or below this many nodes use the dense tier by default.
_DENSE_AUTO_MAX_NODES = 8192


def resolve_mode(mode: str, num_rows: int, num_cols: int) -> str:
    """``mode``, with ``"auto"`` resolved for an operator of ``num_rows``
    rows and ``num_cols`` columns: ``dense`` where neither exceeds 8192,
    else ``mxu``."""
    if mode != "auto":
        return mode
    return ("dense" if max(num_rows, num_cols) <= _DENSE_AUTO_MAX_NODES
            else "mxu")


_MATMUL_PRECISION = "highest"


def set_matmul_precision(p: str) -> None:
    """``"highest"`` keeps float32 matmuls in full float32 (TF32 off);
    ``"high"`` and ``"default"`` allow TF32 on the card."""
    global _MATMUL_PRECISION
    if p not in ("default", "high", "highest"):
        raise ValueError(f"unknown matmul precision {p!r}")
    torch.backends.cuda.matmul.allow_tf32 = p != "highest"
    _MATMUL_PRECISION = p


def get_matmul_precision() -> str:
    return _MATMUL_PRECISION


# Message type of the ``mxu`` tier (None = the features' own type).  bf16
# rounds every message to bf16 while the kernel still sums in float32.
_MESSAGE_DTYPE: Optional[torch.dtype] = None


def set_message_dtype(dt) -> None:
    global _MESSAGE_DTYPE
    if isinstance(dt, str):
        dt = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
              "f32": None, "float32": None, "none": None}[dt.lower()]
    _MESSAGE_DTYPE = dt


def get_message_dtype() -> Optional[torch.dtype]:
    return _MESSAGE_DTYPE


def _kernel_dtype(x: torch.Tensor) -> torch.dtype:
    dt = _MESSAGE_DTYPE or x.dtype
    return dt if dt in (torch.float32, torch.bfloat16) else torch.float32


def spmm_coo(A: COO, x: torch.Tensor) -> torch.Tensor:
    """out[row] += val * x[col]  — i.e. ``A @ x`` for 2-D x [M, F]."""
    msgs = A.val[:, None] * x[A.col]
    return segment_sum(msgs, A.row, A.num_nodes)


# ---------------------------------------------------------------------------
# CSR layouts of the kernel tier


@dataclass(frozen=True)
class CSR:
    """One operator in the kernel tier's layout, plus its transpose.

    ``col`` [nnz] int32 and ``val`` [nnz] float32 in layout order.  Flat
    layouts have ``rowptr`` [num_rows+1] int32 and its plan of cut rows
    ``row_split``; column-split or streamed
    ones (ops/layout.py) have ``blocks`` instead, of which the first
    ``hot_blocks`` gather from ``x[hot_ids]``.  ``transposed`` is the
    same operator in column order, with its own split and stream."""

    rowptr: Optional[torch.Tensor]
    col: torch.Tensor
    val: torch.Tensor
    num_rows: int
    num_cols: int
    transposed: Optional["CSR"] = None
    blocks: Tuple[CsrBlock, ...] = ()
    hot_blocks: int = 0
    hot_ids: Optional[torch.Tensor] = None
    streamed: bool = False
    row_split: Optional[RowSplit] = None


def _layout_fields(L: CsrLayout) -> dict:
    return dict(rowptr=L.rowptr, col=L.col, blocks=L.blocks,
                hot_blocks=L.hot_blocks, hot_ids=L.hot_ids,
                streamed=L.streamed, row_split=L.row_split)


def _csr_from_coo(A: COO) -> CSR:
    """The kernel tier's operator and its transpose, each split and
    streamed as ops/layout.py's knobs say at call time."""
    row, col = A.row.cpu().numpy(), A.col.cpu().numpy()
    val = A.val.to(torch.float32)
    L_t, p_t = build_layout(col, row, A.num_cols, A.num_nodes, A.val.device)
    L, p = build_layout(row, col, A.num_nodes, A.num_cols, A.val.device)
    t = CSR(val=val[p_t].contiguous(), num_rows=A.num_cols,
            num_cols=A.num_nodes, **_layout_fields(L_t))
    return CSR(val=val[p].contiguous(), num_rows=A.num_nodes,
               num_cols=A.num_cols, transposed=t, **_layout_fields(L))


def _apply_span(d, val_a, val_b, n_rows: int, x: torch.Tensor):
    """The span ``pgsd.spmm.apply`` of one apply, with what its least
    time is counted from: the layout, the operator's rows, columns,
    nonzeros and value arrays (1 where both lanes take one), the lanes,
    the message bytes and the K2 blocks."""
    layout = "streamed" if d.streamed else "split" if d.blocks else "flat"
    return span("spmm.apply", layout=layout, rows=n_rows, cols=x.shape[0],
                nnz=d.col.numel(), values=1 if val_a is val_b else 2,
                width=x.shape[1], elem=_kernel_dtype(x).itemsize,
                blocks=len(d.blocks))


def _layout_apply(d, val_a, val_b, n_rows: int, x: torch.Tensor,
                  fa: int) -> torch.Tensor:
    """Apply one direction of a kernel-tier operator (a CSR or a
    DualPropagator) to x; lanes below ``fa`` take ``val_a``.

    Flat layouts are one K1 call.  Split or streamed layouts gather the
    hot table ``x[hot_ids]`` once, then call K2 for each block, in order,
    into one float32 output; rows no block touches stay 0.  Each call
    takes its rowptr's plan of cut rows, and is the span
    ``pgsd.spmm.apply``."""
    with (_apply_span(d, val_a, val_b, n_rows, x) if tracing()
          else NO_SPAN):
        xm = x.to(_kernel_dtype(x)).contiguous()
        if not d.blocks:
            out = csr_dual_spmm(d.rowptr, d.col, val_a, val_b, xm, fa,
                                d.row_split)
            return out.to(x.dtype)
        x_hot = (xm.index_select(0, d.hot_ids) if d.hot_ids is not None
                 else None)
        out = torch.zeros((n_rows, x.shape[1]), dtype=torch.float32,
                          device=x.device)
        for i, b in enumerate(d.blocks):
            csr_dual_spmm_accum(b.rowptr, d.col[b.e0:b.e1],
                                val_a[b.e0:b.e1], val_b[b.e0:b.e1],
                                x_hot if i < d.hot_blocks else xm, fa, out,
                                b.row0, b.split)
        return out.to(x.dtype)


class _CsrSpmm(torch.autograd.Function):
    """``A @ x`` on the kernel tier; the backward is ``A^T @ g``."""

    @staticmethod
    def forward(ctx, x, A):
        ctx.A = A
        return _csr_apply(A, x)

    @staticmethod
    def backward(ctx, g):
        return _csr_apply(ctx.A.transposed, g.contiguous()), None


def _csr_apply(A: CSR, x: torch.Tensor) -> torch.Tensor:
    # one operator: every lane selects val (fa = width)
    return _layout_apply(A, A.val, A.val, A.num_rows, x, x.shape[1])


# ---------------------------------------------------------------------------
# Single operators


def _dense_apply(dense: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if dense.dtype == torch.bfloat16:
        # a bf16 operator (``dense_dtype``): x rounds to bf16 and the
        # product of the bf16 operands is taken and returned in float32
        # (each bf16 product is exact in float32), as the JAX tier's
        # preferred_element_type=float32 does
        xb = x.to(torch.bfloat16).to(torch.float32)
        return torch.matmul(dense.to(torch.float32), xb).to(x.dtype)
    return torch.matmul(dense, x)


@dataclass(frozen=True)
class Propagator:
    """A frozen linear operator ``x -> A @ x`` with a fixed tier.
    ``sharded`` holds the shards of an operator sharded across a mesh
    (parallel/): a parallel.mxu_shard.ShardedMXU on ``mxu_sharded``, a
    parallel.sharded.ShardedDense, ShardedSegment or ShardedBSR on the
    dense, segment and bsr tiers."""

    coo: Optional[COO]
    dense: Optional[torch.Tensor]
    mode: str
    csr: Optional[CSR] = None
    bsr: Optional[BSR] = None
    sharded: Optional[object] = None

    @property
    def num_nodes(self) -> int:
        if self.sharded is not None:
            return self.sharded.num_rows
        if self.mode == "dense":
            return self.dense.shape[0]
        if self.mode == "mxu":
            return self.csr.num_rows
        if self.mode == "bsr":
            return self.bsr.num_rows
        return self.coo.num_nodes

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.sharded is not None:
            return self.sharded.apply(x)
        if self.mode == "dense":
            return _dense_apply(self.dense, x)
        if self.mode == "mxu":
            return _CsrSpmm.apply(x, self.csr)
        if self.mode == "bsr":
            return bsr_spmm(self.bsr, x)
        return spmm_coo(self.coo, x)


def make_propagator(
    row,
    col,
    val=None,
    num_nodes: Optional[int] = None,
    *,
    mode: str = "auto",
    pad_to: Optional[int] = None,
    dtype=np.float32,
    device: DeviceLike = None,
) -> Propagator:
    """Host-side factory.  ``mode`` in {'auto', 'dense', 'segment', 'mxu',
    'bsr'}.  ``dtype`` is the values' type, as in ``build_coo`` (the mxu
    and bsr tiers hold float32 values, their kernels' type); ``pad_to`` is
    accepted for the JAX signature and not read (no padding)."""
    A = build_coo(row, col, val, num_nodes, dtype=dtype, device=device)
    return propagator_from_coo(A, mode=mode)


def _check_mode(mode: str) -> None:
    if mode not in ("auto", "dense", "segment", "mxu", "bsr"):
        raise ValueError(f"unknown mode {mode!r}")


def propagator_from_coo(A: COO, mode: str = "auto",
                        dense_dtype: Optional[torch.dtype] = None
                        ) -> Propagator:
    """Freeze ``A`` into a Propagator of the given tier (on A's device).
    ``dense_dtype=torch.bfloat16`` stores a dense operator in bf16 (half
    the memory it holds between calls; each call widens it to float32 for
    the product), for training that does not need float32 parity."""
    _check_mode(mode)
    mode = resolve_mode(mode, A.num_nodes, A.num_cols)
    if mode == "dense":
        dense = A.to_dense()
        if dense_dtype is not None:
            dense = dense.to(dense_dtype)
        return Propagator(coo=None, dense=dense, mode="dense")
    if mode == "mxu":
        return Propagator(coo=None, dense=None, mode="mxu",
                          csr=_csr_from_coo(A))
    if mode == "bsr":
        return Propagator(coo=None, dense=None, mode="bsr",
                          bsr=bsr_from_coo(A))
    return Propagator(coo=A, dense=None, mode="segment")


# ---------------------------------------------------------------------------
# Fused operator pairs


@dataclass(frozen=True)
class DualPropagator:
    """Two operators with one sparsity structure, applied as ONE gather and
    one segment sum to a lane-stacked ``[x_a | x_b]``.

    ``mxu``: int32 ``col`` in the layout's order, with ``rowptr`` [N+1]
    int32 and its plan ``row_split`` (flat) or ``blocks`` (column-split or
    streamed, as in CSR).
    ``segment``: int64 ``row`` and ``col`` sorted by (row, col).
    ``val_a``/``val_b`` are float32 in the same order.  A pair sharded
    across a mesh holds both in ``sharded``: a parallel.mxu_shard.ShardedMXU
    (``mxu_sharded``) or a parallel.sharded.ShardedSegment (``segment``).
    ``transposed`` is the pair's transpose, whose forward is this pair's
    backward."""

    col: torch.Tensor
    row: Optional[torch.Tensor]       # segment tier
    rowptr: Optional[torch.Tensor]    # mxu tier, flat layouts
    val_a: torch.Tensor
    val_b: torch.Tensor
    num_nodes: int
    num_cols: int
    mode: str
    transposed: Optional["DualPropagator"] = None
    blocks: Tuple[CsrBlock, ...] = ()
    hot_blocks: int = 0
    hot_ids: Optional[torch.Tensor] = None
    streamed: bool = False
    sharded: Optional[object] = None
    row_split: Optional[RowSplit] = None


def dual_propagator(row, col, val_a, val_b, num_nodes: Optional[int] = None,
                    num_cols: Optional[int] = None, mode: str = "auto",
                    with_transpose: bool = True,
                    device: DeviceLike = None) -> Optional[DualPropagator]:
    """Build a fused operator pair from one shared (row, col) edge list.

    Returns None on the dense and bsr tiers, where fusion buys nothing:
    callers then apply the two operators separately.  On ``mxu`` the
    column split and the stream follow ops/layout.py's knobs, read at call
    time; the transposed pair takes its own split and stream.  With
    ``with_transpose=False`` no transposed pair is built (``transposed``
    is None): the pair then applies forward only, as in JAX."""
    _check_mode(mode)
    device = resolve_device(device)
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    val_a = np.asarray(val_a, np.float32)
    val_b = np.asarray(val_b, np.float32)
    num_nodes = int(num_nodes if num_nodes is not None
                    else (row.max() + 1 if row.size else 0))
    num_cols = int(num_cols) if num_cols is not None else num_nodes
    mode = resolve_mode(mode, num_nodes, num_cols)
    if mode in ("dense", "bsr"):
        return None
    check_indices(row, col, num_nodes, num_cols)

    va = torch.from_numpy(val_a).to(device)
    vb = torch.from_numpy(val_b).to(device)
    if mode == "mxu":
        t = None
        if with_transpose:
            L_t, p_t = build_layout(col, row, num_cols, num_nodes, device)
            t = DualPropagator(
                row=None, val_a=va[p_t].contiguous(),
                val_b=vb[p_t].contiguous(), num_nodes=num_cols,
                num_cols=num_nodes, mode="mxu", **_layout_fields(L_t))
        L, p = build_layout(row, col, num_nodes, num_cols, device)
        return DualPropagator(
            row=None, val_a=va[p].contiguous(), val_b=vb[p].contiguous(),
            num_nodes=num_nodes, num_cols=num_cols, mode="mxu",
            transposed=t, **_layout_fields(L))

    r = torch.from_numpy(row).to(device)
    c = torch.from_numpy(col).to(device)

    def segment_one(r, c, n_rows, n_cols, t=None):
        order = torch.from_numpy(np.lexsort(
            (c.cpu().numpy(), r.cpu().numpy()))).to(device)
        return DualPropagator(
            col=c[order], row=r[order], rowptr=None, val_a=va[order],
            val_b=vb[order], num_nodes=n_rows, num_cols=n_cols,
            mode="segment", transposed=t)

    return segment_one(r, c, num_nodes, num_cols,
                       segment_one(c, r, num_cols, num_nodes)
                       if with_transpose else None)


def propagators_from_dual(D: DualPropagator) -> Tuple[Propagator, Propagator]:
    """The pair's two operators as standalone Propagators — views over
    the dual's tensors (layout, split and stream included), no rebuild."""
    if D.mode == "mxu":
        def one(d, which):
            t = one(d.transposed, which) if d.transposed is not None else None
            return CSR(rowptr=d.rowptr, col=d.col,
                       val=d.val_a if which == "a" else d.val_b,
                       num_rows=d.num_nodes, num_cols=d.num_cols,
                       transposed=t, blocks=d.blocks,
                       hot_blocks=d.hot_blocks, hot_ids=d.hot_ids,
                       streamed=d.streamed, row_split=d.row_split)

        return (Propagator(coo=None, dense=None, mode="mxu", csr=one(D, "a")),
                Propagator(coo=None, dense=None, mode="mxu", csr=one(D, "b")))
    if D.mode != "segment":
        raise ValueError(f"cannot split a {D.mode!r}-tier dual")
    A = COO(row=D.row, col=D.col, val=D.val_a, num_nodes=D.num_nodes,
            num_cols=D.num_cols)
    B = COO(row=D.row, col=D.col, val=D.val_b, num_nodes=D.num_nodes,
            num_cols=D.num_cols)
    return (Propagator(coo=A, dense=None, mode="segment"),
            Propagator(coo=B, dense=None, mode="segment"))


def _dual_forward_stacked(D: DualPropagator, x: torch.Tensor) -> torch.Tensor:
    if x.shape[1] % 2:
        raise ValueError(
            f"dual_spmm_stacked needs an even lane-stacked width, got "
            f"{x.shape[1]}")
    fa = x.shape[1] // 2
    if D.sharded is not None:
        return D.sharded.forward_stacked(x)
    if D.mode == "mxu":
        return _layout_apply(D, D.val_a, D.val_b, D.num_nodes, x, fa)
    lane = torch.arange(2 * fa, device=x.device) < fa
    msgs = x[D.col] * torch.where(lane[None, :], D.val_a[:, None],
                                  D.val_b[:, None])
    return segment_sum(msgs, D.row, D.num_nodes)


class _DualSpmmStacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, D):
        ctx.D = D
        return _dual_forward_stacked(D, x)

    @staticmethod
    def backward(ctx, g):
        if ctx.D.transposed is None:
            raise ValueError("the dual was built with with_transpose=False "
                             "and has no backward")
        return _dual_forward_stacked(ctx.D.transposed, g.contiguous()), None


def dual_spmm_stacked(D: DualPropagator, x: torch.Tensor) -> torch.Tensor:
    """[A x_a | B x_b] for lane-stacked x = [x_a | x_b] ([N, 2F]).

    One gather + one segment sum; the per-edge value is selected by lane.
    The backward is this function on ``D.transposed``."""
    return _DualSpmmStacked.apply(x, D)


class _DualSpmmTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, val_a, val_b, D):
        ctx.D = D
        ctx.save_for_backward(x)
        return _dual_forward_stacked(D, x)

    @staticmethod
    def backward(ctx, g):
        D = ctx.D
        (x,) = ctx.saved_tensors
        g = g.contiguous()
        dx = (_dual_forward_stacked(D.transposed, g)
              if ctx.needs_input_grad[0] else None)
        fa = x.shape[1] // 2
        rows = D.row if D.mode == "segment" else _row_ids(D.rowptr)
        prod = g[rows] * x[D.col.long()]
        return dx, prod[:, :fa].sum(1), prod[:, fa:].sum(1), None


def dual_spmm_stacked_trainable(D: DualPropagator,
                                x: torch.Tensor) -> torch.Tensor:
    """``dual_spmm_stacked`` whose backward also gives the per-edge value
    cotangents ``dval[e] = sum_f g[row_e, f] x[col_e, f]`` over each lane
    half (an SDDMM): the generic path for operator values that carry
    gradients, such as ``template_dual``'s.  Flat ``mxu`` layouts and the
    segment tier only."""
    if D.sharded is not None:
        raise ValueError("trainable operator values need an unsharded "
                         "pair; shard a MagneticTemplate instead")
    if D.hot_ids is not None or D.streamed:
        raise ValueError("trainable operator values need a flat layout or "
                         "the segment tier; use template_dual_apply on "
                         "split or streamed templates")
    if D.transposed is None:
        raise ValueError("the dual has no transpose to differentiate with")
    return _DualSpmmTrainable.apply(x, D.val_a, D.val_b, D)


def dual_spmm(D: DualPropagator, x_a: torch.Tensor, x_b: torch.Tensor):
    """(A x_a, B x_b) for same-structure A, B — one gather, one sum."""
    if x_a.shape[1] != x_b.shape[1]:
        raise ValueError(
            f"dual_spmm operands must share a feature width (the lane "
            f"split assigns val_a/val_b by halves); got {x_a.shape[1]} "
            f"vs {x_b.shape[1]}")
    fa = x_a.shape[1]
    out = dual_spmm_stacked(D, torch.cat([x_a, x_b], dim=1))
    return out[:, :fa], out[:, fa:]


def complex_spmm(
    P_re: Propagator, P_im: Propagator, x_re: torch.Tensor,
    x_im: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L_re + i·L_im) @ (x_re + i·x_im), as two real pairs."""
    a, b = P_re(x_re), P_im(x_im)
    c, d = P_re(x_im), P_im(x_re)
    return a - b, c + d
