"""The fused scatter + SDDMM over the kernel tier's layouts.

Counterpart of the entries ``dual_scatter_sddmm``,
``split_dual_scatter_sddmm`` and ``streamed_dual_scatter_sddmm`` of
``pytorch_geometric_signed_directed_tpu/ops/pallas/scatter_mxu.py``, over
the port's ``CsrLayout`` (ops/layout.py) or any operator that carries its
fields (a ``DualPropagator``, a ``MagneticTemplate``).  Each returns

    (out [N, W] float32, acc [W] float32)

with ``out[r] = sum_e round(sel(va, vb)[e] * g[col[e]])`` (the transposed
apply of a cotangent) and ``acc = sum_r x[r] * sum_e sel(wa, wb)[e] *
g[col[e]]`` (the lane partials of its derivative by a scalar; ``sum(acc)``
is that derivative), ``sel`` taking the a-value for lanes below ``fa``.
``va``..``wb`` are per-edge float32 in the layout's order, ``g`` the
gather table (float32 or bfloat16) and ``x`` the float32 [N, W] table of
the operator's rows.  The TPU entries take the gathered ``g[col]``; the
kernels here gather it themselves, from ``g[hot_ids]`` in the hot blocks
of a column-split layout, and cut hub rows by each rowptr's plan
(``row_split``, ``CsrBlock.split``), which every layout carries.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .cuda.dual_sddmm import csr_dual_sddmm, csr_dual_sddmm_accum

Result = Tuple[torch.Tensor, torch.Tensor]


def dual_scatter_sddmm(L, g, va, vb, wa, wb, x, fa: int) -> Result:
    """A flat layout: one launch of K3 (``csr_dual_sddmm``)."""
    if L.blocks:
        raise ValueError("dual_scatter_sddmm takes a flat layout; use "
                         "split_dual_scatter_sddmm or "
                         "streamed_dual_scatter_sddmm")
    return csr_dual_sddmm(L.rowptr, L.col, va, vb, wa, wb, g, x, fa,
                          L.row_split)


def _blocks(L, g, va, vb, wa, wb, x, fa: int) -> Result:
    """K4 (``csr_dual_sddmm_accum``) once per block, in order, into one
    zeroed (out, acc); rows no block touches stay 0."""
    g_hot = g.index_select(0, L.hot_ids) if L.hot_ids is not None else None
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    acc = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for i, b in enumerate(L.blocks):
        s = slice(b.e0, b.e1)
        csr_dual_sddmm_accum(b.rowptr, L.col[s], va[s], vb[s], wa[s], wb[s],
                             g_hot if i < L.hot_blocks else g, x, fa, out,
                             acc, b.row0, b.split)
    return out, acc


def split_dual_scatter_sddmm(L, g, va, vb, wa, wb, x, fa: int) -> Result:
    """A column-split layout that is not streamed: the hot block gathers
    from ``g[hot_ids]``, the cold block from ``g``."""
    if L.hot_ids is None or L.streamed:
        raise ValueError("split_dual_scatter_sddmm takes a column-split, "
                         "unstreamed layout")
    return _blocks(L, g, va, vb, wa, wb, x, fa)


def streamed_dual_scatter_sddmm(L, g, va, vb, wa, wb, x, fa: int) -> Result:
    """A streamed layout (column-split or not): one K4 launch per block."""
    if not L.streamed:
        raise ValueError("streamed_dual_scatter_sddmm takes a streamed "
                         "layout")
    return _blocks(L, g, va, vb, wa, wb, x, fa)
