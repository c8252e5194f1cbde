"""MagNetConv's complex combine, bias and complex ReLU as one pass on the card.

The JAX package has no kernel here: XLA fuses these elementwise steps
into the layer's einsums.  On the card they were a dozen PyTorch passes
over [N, F] float32 tensors, forward and backward, around the weight
products.  The layer's products leave ``y = [o1 | o2]`` lane-stacked
([N, 2F], row n holding o1[n] then o2[n]); the kernel in
``csrc/complex_epilogue.cu`` reads it once and writes

    z = [m * (o1 - o2 + b) | m * (o1 + o2 + b)],   m = (o1 - o2 + b >= 0)

(m = 1 without the activation), keeping m as one byte a node and lane.
Its backward reads ``dz = [d_re | d_im]`` and m once and writes the
gradient of ``[o1 | o2]``, ``[m d_re + m d_im | m d_im - m d_re]``, and
the bias gradient, the column sums of the first half, in float64 without
atomics and rounded once.  What bounds both is bytes: 17F bytes a row
(``bytes_moved``).

Each entry has its plain PyTorch version beside it.  A wrapper takes the
plain version only for tensors on the CPU and for float64 ones (a model
run in float64 as a reference; the kernel is float32); for other CUDA
tensors it launches the kernel or raises.  ``LAUNCHES`` counts calls
that launched, in the counter group ``"complex_epilogue"`` of their own
(not in ``ops.cuda.launch_counts()``, which counts the sparse kernels);
each such call is also the span ``pgsd.kernel.<entry>`` (``instrument``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ...instrument import counter, span
from . import build
from .scatter_csr import _check, _on, _stream_ptr

LAUNCHES = counter("complex_epilogue", ("complex_epilogue",
                                        "complex_epilogue_backward"))

THREADS = 256
# Row CTAs an SM: 8 of 256 threads fill its 2,048 thread slots.
CTAS_PER_SM = 8

_SOURCE = "complex_epilogue.cu"
_lib = None
_sms: Dict[int, int] = {}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures on a loaded build of the source."""
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.pgsd_complex_epilogue.restype = i
    lib.pgsd_complex_epilogue.argtypes = [p] * 4 + [i64] + [i] * 5 + [p]
    lib.pgsd_complex_epilogue_backward.restype = i
    lib.pgsd_complex_epilogue_backward.argtypes = ([p] * 5 + [i64]
                                                   + [i] * 4 + [p])
    return lib


def _library():
    global _lib
    if _lib is None:
        _lib = bind(build.load(_SOURCE))
    return _lib


def bytes_moved(n: int, f: int) -> int:
    """Bytes one call (forward or backward) must move at n rows of width
    2F: the [n, 2F] float32 input read and output written once, and the
    mask's byte a node and lane."""
    return n * (16 * f + f)


def plan(n: int, f: int, aligned: bool, sms: int) -> Tuple[int, int, int]:
    """``(vec, lt, ctas)``: lanes a thread (4 where F is a multiple of 4
    and the rows start 16-byte aligned, else 1), threads across a row (the
    column groups rounded up to a power of two, at most ``THREADS``) and
    CTAs along the rows (enough for every row, at most ``CTAS_PER_SM`` an
    SM)."""
    vec = 4 if f % 4 == 0 and aligned else 1
    lt = min(1 << max(f // vec - 1, 0).bit_length(), THREADS)
    rows = THREADS // lt
    return vec, lt, max(1, min(-(-n // rows), CTAS_PER_SM * sms))


def _sm_count(device: torch.device) -> int:
    if device.index not in _sms:
        _sms[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device.index]


def complex_epilogue_plain(y: torch.Tensor, bias: Optional[torch.Tensor],
                           activation: bool
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of ``complex_epilogue``, in y's type."""
    f = y.shape[1] // 2
    o1, o2 = y[:, :f], y[:, f:]
    re, im = o1 - o2, o1 + o2
    if bias is not None:
        re, im = re + bias, im + bias
    if not activation:
        return torch.cat([re, im], dim=1), None
    mask = re >= 0
    m = mask.to(y.dtype)
    return torch.cat([m * re, m * im], dim=1), mask


def complex_epilogue_backward_plain(
        dz: torch.Tensor, mask: Optional[torch.Tensor], with_bias: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of ``complex_epilogue_backward``; the bias
    gradient is summed in float64 and rounded once to dz's type."""
    f = dz.shape[1] // 2
    d_re, d_im = dz[:, :f], dz[:, f:]
    if mask is not None:
        m = mask.to(dz.dtype)
        d_re, d_im = d_re * m, d_im * m
    u = d_re + d_im
    db = u.sum(0, dtype=torch.float64).to(dz.dtype) if with_bias else None
    return torch.cat([u, d_im - d_re], dim=1), db


def _checked(name: str, t: torch.Tensor, dev) -> Tuple[int, int, bool]:
    """Validate a lane-stacked [n, 2F] float32 operand; returns
    (n, F, rows start 16-byte aligned)."""
    _check(name, t, (torch.float32,), 2, dev)
    if t.shape[1] % 2:
        raise ValueError(f"{name} must be lane-stacked [n, 2F], got width "
                         f"{t.shape[1]}")
    f = t.shape[1] // 2
    return t.shape[0], f, t.data_ptr() % 16 == 0


def complex_epilogue(y: torch.Tensor, bias: Optional[torch.Tensor],
                     activation: bool, keep_mask: bool = True
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(z [n, 2F], mask [n, F] bool or None)`` of the module docstring
    for ``y = [o1 | o2]`` [n, 2F]; ``bias`` [F] or None.  The mask is kept
    only with ``activation`` and ``keep_mask``."""
    if y.device.type == "cpu" or y.dtype == torch.float64:
        z, mask = complex_epilogue_plain(y, bias, activation)
        return z, mask if keep_mask else None
    if y.device.type != "cuda":
        raise ValueError(f"complex_epilogue takes CPU or CUDA tensors, got "
                         f"{y.device}")
    dev = y.device
    y = y.contiguous()
    n, f, aligned = _checked("y", y, dev)
    if bias is not None:
        _check("bias", bias, (torch.float32,), 1, dev)
        if bias.numel() != f:
            raise ValueError(f"bias has {bias.numel()} entries, the width "
                             f"is {f}")
    z = torch.empty_like(y)
    mask = (torch.empty((n, f), dtype=torch.bool, device=dev)
            if activation and keep_mask else None)
    if n == 0 or f == 0:
        return z, mask
    vec, lt, ctas = plan(n, f, aligned, _sm_count(dev))
    with span("kernel.complex_epilogue", rows=n, width=2 * f):
        err = _on(dev, _library().pgsd_complex_epilogue, y.data_ptr(),
                  None if bias is None else bias.data_ptr(), z.data_ptr(),
                  None if mask is None else mask.data_ptr(), n, f,
                  int(activation), vec, lt, ctas, _stream_ptr(dev))
        if err:
            raise RuntimeError(f"complex_epilogue launch failed: CUDA error "
                               f"{err}")
        LAUNCHES["complex_epilogue"] += 1
    return z, mask


def complex_epilogue_backward(dz: torch.Tensor, mask: Optional[torch.Tensor],
                              with_bias: bool
                              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(uv [n, 2F], db [F] or None)``: the gradients of ``y`` and of the
    bias for the incoming ``dz = [d_re | d_im]`` and the forward's mask
    (None without the activation).  Deterministic: no float atomics."""
    if dz.device.type == "cpu" or dz.dtype == torch.float64:
        return complex_epilogue_backward_plain(dz, mask, with_bias)
    if dz.device.type != "cuda":
        raise ValueError(f"complex_epilogue_backward takes CPU or CUDA "
                         f"tensors, got {dz.device}")
    dev = dz.device
    dz = dz.contiguous()
    n, f, aligned = _checked("dz", dz, dev)
    if mask is not None:
        _check("mask", mask, (torch.bool,), 2, dev)
        if tuple(mask.shape) != (n, f):
            raise ValueError(f"mask {tuple(mask.shape)} must be [{n}, {f}]")
        aligned = aligned and mask.data_ptr() % 4 == 0
    uv = torch.empty_like(dz)
    if n == 0 or f == 0:
        return uv, (torch.zeros(f, dtype=torch.float32, device=dev)
                    if with_bias else None)
    vec, lt, ctas = plan(n, f, aligned, _sm_count(dev))
    db = torch.empty(f, dtype=torch.float32, device=dev) if with_bias else None
    with span("kernel.complex_epilogue_backward", rows=n, width=2 * f):
        partial = (torch.empty((ctas, f), dtype=torch.float64, device=dev)
                   if with_bias else None)
        err = _on(dev, _library().pgsd_complex_epilogue_backward,
                  dz.data_ptr(), None if mask is None else mask.data_ptr(),
                  uv.data_ptr(),
                  None if partial is None else partial.data_ptr(),
                  None if db is None else db.data_ptr(), n, f, vec, lt, ctas,
                  _stream_ptr(dev))
        if err:
            raise RuntimeError(f"complex_epilogue_backward launch failed: "
                               f"CUDA error {err}")
        LAUNCHES["complex_epilogue_backward"] += 1
    return uv, db
