"""SpMM: sparse operator × dense features, the hot op of every GNN layer.

Counterpart of ``pytorch_geometric_signed_directed_tpu/ops/spmm.py``.  The
mode strings are the JAX package's, so both take the same arguments:

  * ``dense``    — the operator materialised once; ``torch.matmul``.
  * ``segment``  — gather + ``index_add_`` (ops.segment.segment_sum).
  * ``mxu``      — on the card, the tier of the hand-written CSR kernel
                   (ops/cuda/scatter_csr.cu, the port of the TPU kernel
                   K1 that the JAX package runs under this name).  CPU
                   tensors take the kernel's plain PyTorch version.
  * ``auto``     — ``dense`` up to 8192 nodes, else ``mxu``.

Every tier is differentiable; on ``mxu`` the backward is the forward of
the transposed operator, built at preparation time.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .coo import COO, build_coo, check_indices
from .cuda.scatter_csr import csr_dual_spmm
from .segment import segment_sum

# Graphs at or below this many nodes use the dense tier by default.
_DENSE_AUTO_MAX_NODES = 8192

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
# CSR layout of the kernel tier


@dataclass(frozen=True)
class CSR:
    """One operator in row order for the kernel tier, plus its transpose.

    ``rowptr`` [num_rows+1] int32, ``col`` [nnz] int32, ``val`` [nnz]
    float32; ``transposed`` is the same operator in column order."""

    rowptr: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    num_rows: int
    num_cols: int
    transposed: Optional["CSR"] = None


def _rowptr(row: torch.Tensor, n_rows: int) -> torch.Tensor:
    counts = torch.bincount(row, minlength=n_rows)
    zero = torch.zeros(1, dtype=counts.dtype, device=row.device)
    return torch.cat([zero, counts.cumsum(0)]).to(torch.int32)


def _csr_order(row: torch.Tensor, col: torch.Tensor, n_rows: int,
               n_cols: int):
    """(rowptr, col, perm) and (rowptr_t, col_t, perm_t): the edges in row
    order and in column order.  Both sorts are stable, so edges that share
    a row keep their input order."""
    if row.numel() >= 2 ** 31:
        raise ValueError(f"nnz={row.numel()} does not fit int32 offsets")
    fwd = torch.argsort(row, stable=True)
    bwd = torch.argsort(col, stable=True)
    return ((_rowptr(row, n_rows), col[fwd].to(torch.int32), fwd),
            (_rowptr(col, n_cols), row[bwd].to(torch.int32), bwd))


def _csr_from_coo(A: COO) -> CSR:
    (rp, c, p), (rp_t, c_t, p_t) = _csr_order(A.row, A.col, A.num_nodes,
                                              A.num_cols)
    val = A.val.to(torch.float32)
    t = CSR(rp_t, c_t, val[p_t].contiguous(), A.num_cols, A.num_nodes)
    return CSR(rp, c, val[p].contiguous(), A.num_nodes, A.num_cols, t)


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
    xm = x.to(_kernel_dtype(x)).contiguous()
    # one operator: every lane selects val (fa = width)
    out = csr_dual_spmm(A.rowptr, A.col, A.val, A.val, xm, x.shape[1])
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Single operators


@dataclass(frozen=True)
class Propagator:
    """A frozen linear operator ``x -> A @ x`` with a fixed tier."""

    coo: Optional[COO]
    dense: Optional[torch.Tensor]
    mode: str
    csr: Optional[CSR] = None

    @property
    def num_nodes(self) -> int:
        if self.mode == "dense":
            return self.dense.shape[0]
        if self.mode == "mxu":
            return self.csr.num_rows
        return self.coo.num_nodes

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "dense":
            return torch.matmul(self.dense, x)
        if self.mode == "mxu":
            return _CsrSpmm.apply(x, self.csr)
        return spmm_coo(self.coo, x)


def make_propagator(
    row,
    col,
    val=None,
    num_nodes: Optional[int] = None,
    *,
    mode: str = "auto",
    device: DeviceLike = None,
) -> Propagator:
    """Host-side factory.  ``mode`` in {'auto', 'dense', 'segment', 'mxu'}."""
    A = build_coo(row, col, val, num_nodes, device=device)
    return propagator_from_coo(A, mode=mode)


def _check_mode(mode: str) -> None:
    if mode == "bsr":
        raise NotImplementedError(
            "the 'bsr' tier (TPU kernel K5) is not ported yet; see "
            "ROADMAP.md queue B")
    if mode not in ("auto", "dense", "segment", "mxu"):
        raise ValueError(f"unknown mode {mode!r}")


def propagator_from_coo(A: COO, mode: str = "auto") -> Propagator:
    """Freeze ``A`` into a Propagator of the given tier (on A's device)."""
    _check_mode(mode)
    if mode == "auto":
        mode = ("dense" if max(A.num_nodes, A.num_cols)
                <= _DENSE_AUTO_MAX_NODES else "mxu")
    if mode == "dense":
        return Propagator(coo=None, dense=A.to_dense(), mode="dense")
    if mode == "mxu":
        return Propagator(coo=None, dense=None, mode="mxu",
                          csr=_csr_from_coo(A))
    return Propagator(coo=A, dense=None, mode="segment")


# ---------------------------------------------------------------------------
# Fused operator pairs


@dataclass(frozen=True)
class DualPropagator:
    """Two operators with one sparsity structure, applied as ONE gather and
    one segment sum to a lane-stacked ``[x_a | x_b]``.

    ``mxu``: ``rowptr`` [N+1] int32 and int32 ``col`` in row order.
    ``segment``: int64 ``row`` and ``col`` sorted by (row, col).
    ``val_a``/``val_b`` are float32 in the same order.  ``transposed`` is
    the pair's transpose, whose forward is this pair's backward."""

    col: torch.Tensor
    row: Optional[torch.Tensor]       # segment tier
    rowptr: Optional[torch.Tensor]    # mxu tier
    val_a: torch.Tensor
    val_b: torch.Tensor
    num_nodes: int
    num_cols: int
    mode: str
    transposed: Optional["DualPropagator"] = None


def dual_propagator(row, col, val_a, val_b, num_nodes: Optional[int] = None,
                    num_cols: Optional[int] = None, mode: str = "auto",
                    device: DeviceLike = None) -> Optional[DualPropagator]:
    """Build a fused operator pair from one shared (row, col) edge list.

    Returns None on the dense tier, where fusion buys nothing: callers
    then apply the two operators separately."""
    _check_mode(mode)
    device = resolve_device(device)
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    val_a = np.asarray(val_a, np.float32)
    val_b = np.asarray(val_b, np.float32)
    num_nodes = int(num_nodes if num_nodes is not None
                    else (row.max() + 1 if row.size else 0))
    num_cols = int(num_cols) if num_cols is not None else num_nodes
    if mode == "auto":
        mode = ("dense" if max(num_nodes, num_cols) <= _DENSE_AUTO_MAX_NODES
                else "mxu")
    if mode == "dense":
        return None
    check_indices(row, col, num_nodes, num_cols)

    r = torch.from_numpy(row).to(device)
    c = torch.from_numpy(col).to(device)
    va = torch.from_numpy(val_a).to(device)
    vb = torch.from_numpy(val_b).to(device)
    if mode == "mxu":
        (rp, cf, p), (rp_t, cf_t, p_t) = _csr_order(r, c, num_nodes,
                                                    num_cols)
        t = DualPropagator(
            col=cf_t, row=None, rowptr=rp_t, val_a=va[p_t].contiguous(),
            val_b=vb[p_t].contiguous(), num_nodes=num_cols,
            num_cols=num_nodes, mode="mxu")
        return DualPropagator(
            col=cf, row=None, rowptr=rp, val_a=va[p].contiguous(),
            val_b=vb[p].contiguous(), num_nodes=num_nodes,
            num_cols=num_cols, mode="mxu", transposed=t)

    def segment_one(r, c, n_rows, n_cols, t=None):
        order = torch.from_numpy(np.lexsort(
            (c.cpu().numpy(), r.cpu().numpy()))).to(device)
        return DualPropagator(
            col=c[order], row=r[order], rowptr=None, val_a=va[order],
            val_b=vb[order], num_nodes=n_rows, num_cols=n_cols,
            mode="segment", transposed=t)

    return segment_one(r, c, num_nodes, num_cols,
                       segment_one(c, r, num_cols, num_nodes))


def propagators_from_dual(D: DualPropagator) -> Tuple[Propagator, Propagator]:
    """The pair's two operators as standalone Propagators — views over
    the dual's tensors, no rebuild."""
    if D.mode == "mxu":
        def one(d, which):
            t = one(d.transposed, which) if d.transposed is not None else None
            return CSR(d.rowptr, d.col, d.val_a if which == "a" else d.val_b,
                       d.num_nodes, d.num_cols, t)

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
    if D.mode == "mxu":
        xm = x.to(_kernel_dtype(x)).contiguous()
        out = csr_dual_spmm(D.rowptr, D.col, D.val_a, D.val_b, xm, fa)
        return out.to(x.dtype)
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
        return _dual_forward_stacked(ctx.D.transposed, g.contiguous()), None


def dual_spmm_stacked(D: DualPropagator, x: torch.Tensor) -> torch.Tensor:
    """[A x_a | B x_b] for lane-stacked x = [x_a | x_b] ([N, 2F]).

    One gather + one segment sum; the per-edge value is selected by lane.
    The backward is this function on ``D.transposed``."""
    return _DualSpmmStacked.apply(x, D)


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
