"""Fused scatter + SDDMM on the card — the port of the TPU kernels K3 and K4.

Counterpart of ``pytorch_geometric_signed_directed_tpu/ops/pallas/
scatter_mxu.py``: K3 (``_dual_bwd_kernel`` / ``_dual_bwd_matmul`` behind
``dual_scatter_sddmm``) and K4 (``_dual_bwd_kernel_accum`` /
``_dual_bwd_accum``, which seeds both outputs from prior values).  Over a
row-sorted CSR (``rowptr`` int32, edges in row order) the kernels in
``csrc/dual_sddmm.cu`` compute, in one pass,

    out[r, l] = sum_e round(sel_l(va, vb)[e] * g[col[e], l])
    acc[l]    = sum_r x[r, l] * sum_e sel_l(wa, wb)[e] * g[col[e], l]

with ``sel_l`` the a-value for lanes ``l < fa``: the transposed apply of a
cotangent ``g`` and the lane partials of its derivative by a scalar
(``sum(acc)``).  The TPU kernels take the gathered ``g[col]``; these
gather it themselves.  The ``*_accum`` entry (K4) adds into ``out`` at rows
``row0 + r`` and into ``acc``, in place, and leaves rows without edges
alone.

Rows longer than ``scatter_csr.PIECE_EDGES`` edges are cut into pieces by
the rowptr's ``RowSplit`` plan (``split``; given none, the wrapper plans
the rowptr itself at the cost of a host sync), as in K1 and K2.

Each entry has its plain PyTorch version beside it, summing in float64.  A
wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  ``LAUNCHES`` counts calls that
launched; each such call is also the span ``pgsd.kernel.<entry>``
(``instrument``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...instrument import counter, span
from . import build
from .scatter_csr import (RowSplit, _check, _check_rowptr, _plan_args,
                          _row_ids, _stream_ptr)

LAUNCHES = counter("kernels", ("csr_dual_sddmm", "csr_dual_sddmm_accum"))

_SOURCE = "dual_sddmm.cu"
_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures on a loaded build of the source."""
    p, i = ctypes.c_void_p, ctypes.c_int
    plan = [p, i, p, p, i, i, p]
    lib.pgsd_csr_dual_sddmm_parts.restype = i
    lib.pgsd_csr_dual_sddmm_parts.argtypes = [i, i, i]
    lib.pgsd_csr_dual_sddmm.restype = i
    lib.pgsd_csr_dual_sddmm.argtypes = [p] * 11 + [i] * 4 + plan + [p]
    lib.pgsd_csr_dual_sddmm_accum.restype = i
    lib.pgsd_csr_dual_sddmm_accum.argtypes = [p] * 11 + [i] * 5 + plan + [p]
    return lib


def _library():
    global _lib
    if _lib is None:
        _lib = bind(build.load(_SOURCE))
    return _lib


def _terms(col, va, vb, wa, wb, g, fa: int):
    """Per-edge apply messages ``round(sel(va, vb) * g[col])`` (rounded to
    g's type, as the kernel rounds them) and dq products
    ``sel(wa, wb) * g[col]`` in float32, both [E, W]."""
    lane = torch.arange(g.shape[1], device=g.device)[None, :] < fa
    ge = g[col.long()].float()
    msgs = (torch.where(lane, va[:, None], vb[:, None]) * ge).to(g.dtype)
    return msgs.double(), (torch.where(lane, wa[:, None], wb[:, None])
                           * ge).double()


def _sums(rowptr, col, va, vb, wa, wb, g, x, fa: int, row0: int):
    """The row sums of both terms and the lane partials, in float64."""
    n, w = rowptr.numel() - 1, g.shape[1]
    ids = _row_ids(rowptr)
    msgs, prods = _terms(col, va, vb, wa, wb, g, fa)
    d = torch.zeros((n, w), dtype=torch.float64, device=g.device)
    m = torch.zeros((n, w), dtype=torch.float64, device=g.device)
    d.index_add_(0, ids, msgs)
    m.index_add_(0, ids, prods)
    return ids, d, (x[row0:row0 + n].double() * m).sum(0)


def csr_dual_sddmm_plain(rowptr, col, va, vb, wa, wb, g, x, fa: int):
    """Plain PyTorch version of ``csr_dual_sddmm``, summed in float64 and
    rounded once to float32."""
    _, d, acc = _sums(rowptr, col, va, vb, wa, wb, g, x, fa, 0)
    return d.float(), acc.float()


def csr_dual_sddmm_accum_plain(rowptr, col, va, vb, wa, wb, g, x, fa: int,
                               out, acc, row0: int = 0):
    """Plain PyTorch version of ``csr_dual_sddmm_accum``: returns new
    ``(out, acc)`` (the arguments are left as they are)."""
    ids, d, part = _sums(rowptr, col, va, vb, wa, wb, g, x, fa, row0)
    new = out.clone()
    rows = torch.unique(ids) + row0
    new[rows] = (out[rows].double() + d[rows - row0]).float()
    return new, (acc.double() + part).float()


def _check_args(rowptr, col, va, vb, wa, wb, g, x, fa: int, row0: int):
    """Validate a CUDA call; returns (device, rows, width)."""
    dev = g.device
    _check("g", g, (torch.float32, torch.bfloat16), 2, dev)
    _check("x", x, (torch.float32,), 2, dev)
    _check("col", col, (torch.int32,), 1, dev)
    for name, v in (("va", va), ("vb", vb), ("wa", wa), ("wb", wb)):
        _check(name, v, (torch.float32,), 1, dev)
        if v.numel() != col.numel():
            raise ValueError("col, va, vb, wa and wb must have one entry per "
                             "edge")
    n = _check_rowptr(rowptr, col.numel(), dev)
    w = g.shape[1]
    if x.shape[1] != w:
        raise ValueError(f"x has width {x.shape[1]}, g has {w}")
    if row0 < 0 or x.shape[0] < row0 + n:
        raise ValueError(f"x has {x.shape[0]} rows, the rows are "
                         f"[{row0}, {row0 + n})")
    if not 0 <= fa <= w:
        raise ValueError(f"fa={fa} outside [0, {w}]")
    return dev, n, w


def _launch(entry: str, args, dev, n: int, w: int, split, *tail) -> None:
    lib = _library()
    rowptr, col, va, vb, wa, wb, g, x, out, acc = args
    with span("kernel." + entry, rows=n, nnz=col.numel(), width=w):
        plan, _partial = _plan_args(rowptr, split, w, dev)
        parts = torch.empty((lib.pgsd_csr_dual_sddmm_parts(n, w, plan[1]),
                             w), dtype=torch.float64, device=dev)
        with torch.cuda.device(dev):
            err = getattr(lib, "pgsd_" + entry)(
                rowptr.data_ptr(), col.data_ptr(), va.data_ptr(),
                vb.data_ptr(), wa.data_ptr(), wb.data_ptr(), g.data_ptr(),
                x.data_ptr(), out.data_ptr(), acc.data_ptr(),
                parts.data_ptr(), n, w, *tail, *plan, _stream_ptr(dev))
        if err:
            raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
        LAUNCHES[entry] += 1


def csr_dual_sddmm(rowptr: torch.Tensor, col: torch.Tensor,
                   va: torch.Tensor, vb: torch.Tensor, wa: torch.Tensor,
                   wb: torch.Tensor, g: torch.Tensor, x: torch.Tensor,
                   fa: int, split: Optional[RowSplit] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [N, W] float32, acc [W] float32)`` of the module docstring
    over the ``N = rowptr.numel() - 1`` rows.

    ``g`` [M, W] is float32 or bfloat16 (apply messages round to its type,
    sums are float32); ``x`` [>= N, W] float32, row r read for row r;
    ``col`` indexes rows of ``g`` (the builders check it once); ``split``
    is rowptr's plan of cut rows.  Rows without edges give 0.
    Deterministic: no float atomics."""
    if g.device.type == "cpu":
        return csr_dual_sddmm_plain(rowptr, col, va, vb, wa, wb, g, x, fa)
    if g.device.type != "cuda":
        raise ValueError(f"csr_dual_sddmm takes CPU or CUDA tensors, got "
                         f"{g.device}")
    dev, n, w = _check_args(rowptr, col, va, vb, wa, wb, g, x, fa, 0)
    out = torch.empty((n, w), dtype=torch.float32, device=dev)
    acc = torch.zeros(w, dtype=torch.float32, device=dev)
    if n == 0 or w == 0:
        return out.zero_(), acc
    _launch("csr_dual_sddmm", (rowptr, col, va, vb, wa, wb, g, x, out, acc),
            dev, n, w, split, fa, int(g.dtype == torch.bfloat16))
    return out, acc


def csr_dual_sddmm_accum(rowptr: torch.Tensor, col: torch.Tensor,
                         va: torch.Tensor, vb: torch.Tensor,
                         wa: torch.Tensor, wb: torch.Tensor, g: torch.Tensor,
                         x: torch.Tensor, fa: int, out: torch.Tensor,
                         acc: torch.Tensor, row0: int = 0,
                         split: Optional[RowSplit] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: ``csr_dual_sddmm`` of one block of a split or streamed layout,
    added in place into ``out`` at rows ``row0 + r`` (rows without edges
    are not written) and into ``acc``; returns ``(out, acc)``.  ``rowptr``
    is local to the block (and ``split`` its plan); ``x`` is indexed by the
    same rows as ``out``."""
    if g.device.type == "cpu":
        new_out, new_acc = csr_dual_sddmm_accum_plain(
            rowptr, col, va, vb, wa, wb, g, x, fa, out, acc, row0)
        return out.copy_(new_out), acc.copy_(new_acc)
    if g.device.type != "cuda":
        raise ValueError(f"csr_dual_sddmm_accum takes CPU or CUDA tensors, "
                         f"got {g.device}")
    dev, n, w = _check_args(rowptr, col, va, vb, wa, wb, g, x, fa, row0)
    _check("out", out, (torch.float32,), 2, dev)
    _check("acc", acc, (torch.float32,), 1, dev)
    if tuple(out.shape) != tuple(x.shape) or acc.numel() != w:
        raise ValueError(f"out {tuple(out.shape)} and acc {tuple(acc.shape)}"
                         f" must match x {tuple(x.shape)} and its width")
    if n == 0 or w == 0:
        return out, acc
    _launch("csr_dual_sddmm_accum",
            (rowptr, col, va, vb, wa, wb, g, x, out, acc), dev, n, w, split,
            fa, int(g.dtype == torch.bfloat16), row0)
    return out, acc
