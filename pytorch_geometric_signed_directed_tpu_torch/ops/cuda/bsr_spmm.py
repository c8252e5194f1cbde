"""Block-sparse-row SpMM on the card — the port of the TPU kernel K5.

Counterpart of ``pytorch_geometric_signed_directed_tpu/ops/pallas/
bsr_spmm.py`` (``_kernel`` / ``_bsr_matmul`` behind ``bsr_spmm``, which
sums at ``Precision.HIGHEST``).  The operator is 128×128 dense float32
blocks sorted by block row.  The kernel in ``csrc/bsr_spmm.cu`` gives one
CTA to each piece of a block row (a run of consecutive blocks,
``plan_block_split``) and feature tile, and a second launch adds each
block row's piece partials in a fixed order.  Unlike the TPU launcher, x
is not padded to 128 lanes: the kernel masks its ragged feature tile and
the padded columns of the last block.

What bounds it is bytes (each 64 KB block read once a feature tile, 16
flop/byte at 32 lanes), which float32 FMAs could only meet at about 80%
of the CUDA cores' peak.  So the products run on the tensor cores in
3xTF32: each operand splits into a TF32 ``hi`` and a TF32 ``lo`` of the
remainder (both rounded to nearest, ties away, as ``cvt.rna``), and
``a_lo·x_hi + a_hi·x_lo + a_hi·x_hi`` (``wgmma`` m64nFTk8, A from
registers, x split once a slab into shared memory) adds into float32
accumulators, each product within about 3·2^-22 of |a·x| (plain TF32:
2^-11, which misses the 1e-5 that HIGHEST holds to).  A producer warp
streams each block as four 32-column slabs (one 2D tensor copy each,
128-byte swizzle) with their x rows (cp.async) through a ring of 3–6
stages tracked by mbarriers; two CTAs share an SM, and the plan makes
about two pieces an SM, one wave.  Feature tiles are 8, 16, 32 or 64
lanes.

``bsr_matmul`` takes its plain PyTorch version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.  ``LAUNCHES``
counts calls that launched (one per call; each call makes two device
launches); each such call is also the span ``pgsd.kernel.bsr_spmm``
(``instrument``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ...instrument import counter, span
from . import build
from .scatter_csr import (RowSplit, _check, _check_split, _row_ids,
                          _stream_ptr, plan_row_split)

BLOCK = 128
# The split aims at this many CTAs per SM: the two that the kernel's shared
# memory lets an SM hold at once, so that the pieces fill the card in one
# wave (a second wave of shorter pieces measured 1-12% slower).
CTAS_PER_SM = 2
# The H100's SM count, for plans made away from a card.
H100_SMS = 132

LAUNCHES = counter("kernels", ("bsr_spmm",))

_SOURCE = "bsr_spmm.cu"
_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signature on a loaded build of the source."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pgsd_bsr_spmm.restype = i
    lib.pgsd_bsr_spmm.argtypes = [p] * 7 + [i] * 5 + [p]
    lib.pgsd_bsr_config.restype = None
    lib.pgsd_bsr_config.argtypes = [i, p, p, p]
    return lib


def _library():
    global _lib
    if _lib is None:
        _lib = bind(build.load(_SOURCE))
    return _lib


def tile_config(width: int) -> Dict[str, int]:
    """The kernel's feature tile, ring stages and dynamic shared memory (a
    CTA) at ``width``, from the build."""
    out = [ctypes.c_int() for _ in range(3)]
    _library().pgsd_bsr_config(width, *map(ctypes.byref, out))
    return dict(zip(("tile", "stages", "smem_bytes"), (v.value for v in out)))


def sm_count(device) -> int:
    """SMs of ``device``'s card, or the H100's for a CPU device."""
    device = torch.device(device)
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def plan_block_split(block_rowptr: torch.Tensor, n_blocks: int,
                     n_sms: int) -> RowSplit:
    """K5's plan: every block row cut into pieces of ``chunk`` consecutive
    blocks, ``chunk = ceil(n_blocks / (CTAS_PER_SM * n_sms))``, so that
    the pieces (one CTA each per feature tile) number about CTAS_PER_SM
    per SM whatever the rows' lengths.  Every block row is listed; one
    without blocks has no piece."""
    chunk = max(1, -(-n_blocks // (CTAS_PER_SM * n_sms)))
    return plan_row_split(block_rowptr, chunk, min_len=-1)


def bsr_matmul_plain(blocks, block_rowptr, block_cols, x, num_rows: int):
    """Plain PyTorch version of ``bsr_matmul``: ``torch.bmm`` of the
    blocks with their gathered x tiles, then ``index_add_`` by block
    row."""
    f = x.shape[1]
    n_br = block_rowptr.numel() - 1
    cols_pad = -(-max(x.shape[0], 1) // BLOCK) * BLOCK
    x_pad = torch.zeros((cols_pad, f), dtype=torch.float32, device=x.device)
    x_pad[: x.shape[0]] = x
    tiles = x_pad.view(-1, BLOCK, f)[block_cols.long()]        # [NB, 128, F]
    out = torch.zeros((n_br, BLOCK, f), dtype=torch.float32, device=x.device)
    out.index_add_(0, _row_ids(block_rowptr), torch.bmm(blocks, tiles))
    return out.view(n_br * BLOCK, f)[:num_rows]


def bsr_matmul(blocks: torch.Tensor, block_rowptr: torch.Tensor,
               block_cols: torch.Tensor, x: torch.Tensor, num_rows: int,
               split: Optional[RowSplit] = None) -> torch.Tensor:
    """``A @ x`` for A in BSR form: ``blocks`` [NB, 128, 128] float32
    sorted by block row, ``block_rowptr`` [ceil(num_rows/128)+1] int32,
    ``block_cols`` [NB] int32; ``x`` [num_cols, F] float32.  ``split`` is
    block_rowptr's plan (``plan_block_split``; made here, with a host
    sync, when None).  Returns float32 [num_rows, F]; a block row without
    blocks comes out 0."""
    if x.device.type == "cpu":
        return bsr_matmul_plain(blocks, block_rowptr, block_cols, x,
                                num_rows)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_matmul takes CPU or CUDA tensors, got "
                         f"{x.device}")
    dev = x.device
    _check("x", x, (torch.float32,), 2, dev)
    _check("blocks", blocks, (torch.float32,), 3, dev)
    _check("block_rowptr", block_rowptr, (torch.int32,), 1, dev)
    _check("block_cols", block_cols, (torch.int32,), 1, dev)
    if blocks.shape[1:] != (BLOCK, BLOCK):
        raise ValueError(f"blocks must be [NB, {BLOCK}, {BLOCK}], got "
                         f"{tuple(blocks.shape)}")
    if blocks.data_ptr() % 16:
        raise ValueError("blocks must start 16-byte aligned (the tensor "
                         "copies read them from there)")
    if block_cols.numel() != blocks.shape[0]:
        raise ValueError("block_cols needs one entry per block")
    n_br = block_rowptr.numel() - 1
    if n_br != -(-num_rows // BLOCK):
        raise ValueError(f"block_rowptr has {n_br} block rows, expected "
                         f"{-(-num_rows // BLOCK)} for {num_rows} rows")
    if split is None:
        split = plan_block_split(block_rowptr, blocks.shape[0], sm_count(dev))
    _check_split(split, dev)
    if split.ptr.numel() != n_br + 1:
        raise ValueError("split must list every block row (plan_block_split)")
    w = x.shape[1]
    out = torch.empty((num_rows, w), dtype=torch.float32, device=dev)
    if num_rows == 0 or w == 0:
        return out
    n_pieces = split.pieces.shape[0]
    with span("kernel.bsr_spmm", rows=num_rows, nnz=blocks.shape[0],
              width=w):
        partial = torch.empty((n_pieces, BLOCK, w), dtype=torch.float32,
                              device=dev)
        with torch.cuda.device(dev):
            err = _library().pgsd_bsr_spmm(
                blocks.data_ptr(), block_cols.data_ptr(), x.data_ptr(),
                out.data_ptr(), partial.data_ptr(), split.pieces.data_ptr(),
                split.ptr.data_ptr(), n_pieces, blocks.shape[0], num_rows,
                x.shape[0], w, _stream_ptr(dev))
        if err:
            raise RuntimeError(f"bsr_spmm launch failed: CUDA error {err}")
        LAUNCHES["bsr_spmm"] += 1
    return out
