"""CSR segment sums on the card — the port of the TPU kernel K1.

Counterpart of ``pytorch_geometric_signed_directed_tpu/ops/pallas/
scatter_mxu.py`` (``_kernel`` / ``_scatter_matmul`` behind
``scatter_sum``).  The TPU kernel lays edges out in windows and chunks and
sums them with one-hot matmuls; here the host layout is plain CSR
(``rowptr [N+1] int32`` with edges in row order) and the kernel in
``csrc/scatter_csr.cu`` is a row-sorted gather-multiply-reduce.

Each entry has its plain PyTorch version beside it.  A wrapper takes the
plain version only for tensors on the CPU; for CUDA tensors it launches
the kernel or raises.  ``LAUNCHES`` counts kernel launches, one per call
that launched.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import build

LAUNCHES: Dict[str, int] = {"csr_dual_spmm": 0, "csr_scatter_sum": 0}

_SOURCE = "scatter_csr.cu"
_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = build.load(_SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pgsd_csr_dual_spmm.restype = i
        lib.pgsd_csr_dual_spmm.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.pgsd_csr_scatter_sum.restype = i
        lib.pgsd_csr_scatter_sum.argtypes = [p, p, p, i, i, i, p]
        _lib = lib
    return _lib


def _row_ids(rowptr: torch.Tensor) -> torch.Tensor:
    n = rowptr.numel() - 1
    counts = (rowptr[1:] - rowptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(n, device=rowptr.device), counts)


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


def _stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# ---------------------------------------------------------------------------
# csr_dual_spmm: gather x, multiply by the lane-selected value, segment-sum


def csr_dual_spmm_plain(rowptr, col, val_a, val_b, x, fa: int):
    """Plain PyTorch version of ``csr_dual_spmm``: ``index_add_`` over
    ``round(val_sel * x[col])`` with the same message rounding."""
    n, w = rowptr.numel() - 1, x.shape[1]
    lane = torch.arange(w, device=x.device) < fa
    sel = torch.where(lane[None, :], val_a[:, None], val_b[:, None])
    msgs = (sel * x[col.long()].float()).to(x.dtype).float()
    out = torch.zeros((n, w), dtype=torch.float32, device=x.device)
    return out.index_add_(0, _row_ids(rowptr), msgs)


def csr_dual_spmm(rowptr: torch.Tensor, col: torch.Tensor,
                  val_a: torch.Tensor, val_b: torch.Tensor, x: torch.Tensor,
                  fa: int) -> torch.Tensor:
    """``out[r, l] = sum_{e in [rowptr[r], rowptr[r+1])} m[e, l]`` with
    ``m[e, l] = round((l < fa ? val_a[e] : val_b[e]) * x[col[e], l])``.

    ``x`` [M, W] is float32 or bfloat16; messages round to x's type and
    sum in float32.  Returns float32 [N, W]; rows without edges are 0.
    ``col`` must index rows of ``x`` (the builders check it once).  The
    kernel is deterministic: each row sums its edges in order."""
    if x.device.type == "cpu":
        return csr_dual_spmm_plain(rowptr, col, val_a, val_b, x, fa)
    if x.device.type != "cuda":
        raise ValueError(f"csr_dual_spmm takes CPU or CUDA tensors, got "
                         f"{x.device}")
    dev = x.device
    _check("x", x, (torch.float32, torch.bfloat16), 2, dev)
    _check("col", col, (torch.int32,), 1, dev)
    _check("val_a", val_a, (torch.float32,), 1, dev)
    _check("val_b", val_b, (torch.float32,), 1, dev)
    nnz = col.numel()
    if val_a.numel() != nnz or val_b.numel() != nnz:
        raise ValueError("col, val_a and val_b must have one entry per edge")
    n = _check_rowptr(rowptr, nnz, dev)
    w = x.shape[1]
    if not 0 <= fa <= w:
        raise ValueError(f"fa={fa} outside [0, {w}]")
    if n == 0 or w == 0:
        return torch.zeros((n, w), dtype=torch.float32, device=dev)
    out = torch.empty((n, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _library().pgsd_csr_dual_spmm(
            rowptr.data_ptr(), col.data_ptr(), val_a.data_ptr(),
            val_b.data_ptr(), x.data_ptr(), out.data_ptr(), n, w, fa,
            int(x.dtype == torch.bfloat16), _stream_ptr(dev))
    if err:
        raise RuntimeError(f"csr_dual_spmm launch failed: CUDA error {err}")
    LAUNCHES["csr_dual_spmm"] += 1
    return out


# ---------------------------------------------------------------------------
# csr_scatter_sum: K1's own contract, segment sum of row-ordered messages


def csr_scatter_sum_plain(rowptr, msgs):
    """Plain PyTorch version of ``csr_scatter_sum`` (``index_add_``)."""
    n = rowptr.numel() - 1
    out = torch.zeros((n, msgs.shape[1]), dtype=torch.float32,
                      device=msgs.device)
    return out.index_add_(0, _row_ids(rowptr), msgs.float())


def csr_scatter_sum(rowptr: torch.Tensor, msgs: torch.Tensor) -> torch.Tensor:
    """Segment sum of row-ordered messages ``msgs [E, F]`` (float32 or
    bfloat16) into float32 ``[N, F]``; rows without edges are 0."""
    if msgs.device.type == "cpu":
        return csr_scatter_sum_plain(rowptr, msgs)
    if msgs.device.type != "cuda":
        raise ValueError(f"csr_scatter_sum takes CPU or CUDA tensors, got "
                         f"{msgs.device}")
    dev = msgs.device
    _check("msgs", msgs, (torch.float32, torch.bfloat16), 2, dev)
    n = _check_rowptr(rowptr, msgs.shape[0], dev)
    w = msgs.shape[1]
    if n == 0 or w == 0:
        return torch.zeros((n, w), dtype=torch.float32, device=dev)
    out = torch.empty((n, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _library().pgsd_csr_scatter_sum(
            rowptr.data_ptr(), msgs.data_ptr(), out.data_ptr(), n, w,
            int(msgs.dtype == torch.bfloat16), _stream_ptr(dev))
    if err:
        raise RuntimeError(f"csr_scatter_sum launch failed: CUDA error {err}")
    LAUNCHES["csr_scatter_sum"] += 1
    return out
