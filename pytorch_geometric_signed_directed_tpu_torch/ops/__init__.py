"""Sparse tier: COO container, segment sum, tiered SpMM, giant-graph
layouts, BSR, the fused scatter + SDDMM, CUDA kernels."""

from .bsr import BSR, bsr_from_coo, bsr_spmm
from .coo import COO, build_coo, coo_from_scipy
from .layout import col_degree_split
from .reorder import apply_permutation, block_density, rcm_permutation
from .sddmm import (
    dual_scatter_sddmm,
    split_dual_scatter_sddmm,
    streamed_dual_scatter_sddmm,
)
from .segment import segment_sum
from .spmm import (
    CSR,
    DualPropagator,
    Propagator,
    complex_spmm,
    dual_propagator,
    dual_spmm,
    dual_spmm_stacked,
    dual_spmm_stacked_trainable,
    get_matmul_precision,
    get_message_dtype,
    make_propagator,
    propagator_from_coo,
    propagators_from_dual,
    set_matmul_precision,
    set_message_dtype,
    spmm_coo,
)

__all__ = [
    "BSR",
    "bsr_from_coo",
    "bsr_spmm",
    "COO",
    "build_coo",
    "coo_from_scipy",
    "col_degree_split",
    "apply_permutation",
    "block_density",
    "rcm_permutation",
    "dual_scatter_sddmm",
    "split_dual_scatter_sddmm",
    "streamed_dual_scatter_sddmm",
    "segment_sum",
    "CSR",
    "DualPropagator",
    "Propagator",
    "complex_spmm",
    "dual_propagator",
    "dual_spmm",
    "dual_spmm_stacked",
    "dual_spmm_stacked_trainable",
    "get_matmul_precision",
    "get_message_dtype",
    "make_propagator",
    "propagator_from_coo",
    "propagators_from_dual",
    "set_matmul_precision",
    "set_message_dtype",
    "spmm_coo",
]
