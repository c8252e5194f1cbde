"""The logit gradient of a softmax-weighted sum, one value an edge, on the
card: ``csrc/attend_grad.cu``.

The backward of the motif attention (``nn/signed/motif_stack.py``) needs,
for every edge e into destination d = ``row[e]``,

    dpre[e] = slope'(pre[e]) * alpha[e]
              * sum_f (table[index[e], f] - out[d, f]) * dout[d, f]

(``slope'`` is 1 where ``pre >= 0``, else ``slope``).  The kernel reads the
three rows where it reduces them, so the [E, F] edge tensors of the
PyTorch composition (``attend_logit_grad_plain``) are never written; it
sums an edge's F products in float64 and rounds once, where PyTorch sums
them in float32, so the two agree to float32 rounding.

The wrapper takes the plain version for CPU tensors; for CUDA ones it
launches the kernel (float32 only) or raises.  ``LAUNCHES`` counts the
launches (in ``ops.cuda.launch_counts()``); each is the span
``pgsd.kernel.attend_logit_grad``.
"""
from __future__ import annotations

import ctypes

import torch

from ...instrument import counter, span
from . import build
from .scatter_csr import _check, _cuda_device, _on, _stream_ptr

LAUNCHES = counter("kernels", ("attend_logit_grad",))

_SOURCE = "attend_grad.cu"
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load(_SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pgsd_attend_logit_grad.restype = i
        lib.pgsd_attend_logit_grad.argtypes = (
            [p] * 7 + [ctypes.c_float, p, ctypes.c_int64] + [i] * 3 + [p])
        _lib = lib
    return _lib


def attend_logit_grad_plain(row, index, table, out, dout, alpha, pre,
                            slope: float) -> torch.Tensor:
    """Plain PyTorch version: the backward's composition, its [E, F]
    gathers included (the slope in ``pre``'s type: float64 keeps it
    whole)."""
    dout_e = dout[row]
    dl = alpha * ((table[index] - out[row]) * dout_e).sum(dim=1)
    return dl * torch.where(pre >= 0, pre.new_ones(()),
                            pre.new_full((), slope))


def attend_logit_grad(row: torch.Tensor, index: torch.Tensor,
                      table: torch.Tensor, out: torch.Tensor,
                      dout: torch.Tensor, alpha: torch.Tensor,
                      pre: torch.Tensor, slope: float) -> torch.Tensor:
    """[E] float32 ``dpre`` (see the module): ``row`` and ``index`` [E]
    int64 (each edge's destination and its row of ``table``), ``table``
    [M, F], ``out`` and ``dout`` [N, F], ``alpha`` and ``pre`` [E]."""
    if table.device.type == "cpu":
        return attend_logit_grad_plain(row, index, table, out, dout, alpha,
                                       pre, slope)
    dev = _cuda_device("attend_logit_grad", table)
    for name, t, dtype, ndim in (
            ("row", row, torch.int64, 1), ("index", index, torch.int64, 1),
            ("table", table, torch.float32, 2), ("out", out, torch.float32, 2),
            ("dout", dout, torch.float32, 2),
            ("alpha", alpha, torch.float32, 1), ("pre", pre, torch.float32, 1)):
        _check(name, t, (dtype,), ndim, dev)
    e, f = row.numel(), table.shape[1]
    if any(v.numel() != e for v in (index, alpha, pre)):
        raise ValueError("row, index, alpha and pre need one entry an edge")
    if out.shape[1] != f or dout.shape != out.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be [N, {f}]")
    dpre = torch.empty(e, dtype=torch.float32, device=dev)
    if e == 0:
        return dpre
    vec = f % 4 == 0 and all(t.data_ptr() % 16 == 0
                             for t in (table, out, dout))
    lanes = -(-f // 4) if vec else f
    g = min(32, 1 << max(lanes - 1, 0).bit_length())
    with span("kernel.attend_logit_grad", nnz=e, width=f):
        err = _on(dev, _library().pgsd_attend_logit_grad,
                  row.data_ptr(), index.data_ptr(), table.data_ptr(),
                  out.data_ptr(), dout.data_ptr(), alpha.data_ptr(),
                  pre.data_ptr(), slope, dpre.data_ptr(), e, f, int(vec), g,
                  _stream_ptr(dev))
        if err:
            raise RuntimeError(f"attend_logit_grad launch failed: CUDA "
                               f"error {err}")
        LAUNCHES["attend_logit_grad"] += 1
    return dpre
