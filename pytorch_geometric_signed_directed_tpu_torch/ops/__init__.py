"""Sparse tier: COO container, segment sum, tiered SpMM, CUDA kernels."""

from .coo import COO, build_coo
from .segment import segment_sum
from .spmm import (
    CSR,
    DualPropagator,
    Propagator,
    complex_spmm,
    dual_propagator,
    dual_spmm,
    dual_spmm_stacked,
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
    "COO",
    "build_coo",
    "segment_sum",
    "CSR",
    "DualPropagator",
    "Propagator",
    "complex_spmm",
    "dual_propagator",
    "dual_spmm",
    "dual_spmm_stacked",
    "get_matmul_precision",
    "get_message_dtype",
    "make_propagator",
    "propagator_from_coo",
    "propagators_from_dual",
    "set_matmul_precision",
    "set_message_dtype",
    "spmm_coo",
]
