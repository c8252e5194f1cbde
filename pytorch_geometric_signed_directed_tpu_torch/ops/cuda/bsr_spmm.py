"""Block-sparse-row SpMM on the card — the port of the TPU kernel K5.

Counterpart of ``pytorch_geometric_signed_directed_tpu/ops/pallas/
bsr_spmm.py`` (``_kernel`` / ``_bsr_matmul`` behind ``bsr_spmm``).  The
operator is 128×128 dense float32 blocks sorted by block row; the kernel
in ``csrc/bsr_spmm.cu`` gives one CTA to each (block row, feature tile).
Unlike the TPU launcher, x is not padded to 128 lanes: the kernel masks
its ragged feature tile and the padded columns of the last block.

``bsr_matmul`` takes its plain PyTorch version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.  ``LAUNCHES``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import build
from .scatter_csr import _check, _row_ids, _stream_ptr

BLOCK = 128

LAUNCHES: Dict[str, int] = {"bsr_spmm": 0}

_SOURCE = "bsr_spmm.cu"
_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = build.load(_SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pgsd_bsr_spmm.restype = i
        lib.pgsd_bsr_spmm.argtypes = [p, p, p, p, p, i, i, i, i, p]
        _lib = lib
    return _lib


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
               block_cols: torch.Tensor, x: torch.Tensor,
               num_rows: int) -> torch.Tensor:
    """``A @ x`` for A in BSR form: ``blocks`` [NB, 128, 128] float32
    sorted by block row, ``block_rowptr`` [ceil(num_rows/128)+1] int32,
    ``block_cols`` [NB] int32; ``x`` [num_cols, F] float32.  Returns
    float32 [num_rows, F]; a block row without blocks comes out 0."""
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
    if block_cols.numel() != blocks.shape[0]:
        raise ValueError("block_cols needs one entry per block")
    n_br = block_rowptr.numel() - 1
    if n_br != -(-num_rows // BLOCK):
        raise ValueError(f"block_rowptr has {n_br} block rows, expected "
                         f"{-(-num_rows // BLOCK)} for {num_rows} rows")
    w = x.shape[1]
    out = torch.empty((num_rows, w), dtype=torch.float32, device=dev)
    if num_rows == 0 or w == 0:
        return out
    with torch.cuda.device(dev):
        err = _library().pgsd_bsr_spmm(
            blocks.data_ptr(), block_rowptr.data_ptr(),
            block_cols.data_ptr(), x.data_ptr(), out.data_ptr(), n_br,
            num_rows, x.shape[0], w, _stream_ptr(dev))
    if err:
        raise RuntimeError(f"bsr_spmm launch failed: CUDA error {err}")
    LAUNCHES["bsr_spmm"] += 1
    return out
