"""Hand-written CUDA kernels for Hopper, built with nvcc at first use."""

from .scatter_csr import (
    LAUNCHES,
    csr_dual_spmm,
    csr_dual_spmm_plain,
    csr_scatter_sum,
    csr_scatter_sum_plain,
    reset_launch_counts,
)

__all__ = ["LAUNCHES", "csr_dual_spmm", "csr_dual_spmm_plain",
           "csr_scatter_sum", "csr_scatter_sum_plain", "reset_launch_counts"]
