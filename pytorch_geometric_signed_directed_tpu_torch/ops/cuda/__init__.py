"""Hand-written CUDA kernels for Hopper, built with nvcc at first use."""

from ...instrument import counts
# in this order, the order of launch_counts()'s keys
from . import scatter_csr, bsr_spmm, dual_sddmm, attend_grad
from .bsr_spmm import bsr_matmul, bsr_matmul_plain
from .dual_sddmm import (
    csr_dual_sddmm,
    csr_dual_sddmm_accum,
    csr_dual_sddmm_accum_plain,
    csr_dual_sddmm_plain,
)
from .scatter_csr import (
    csr_dual_spmm,
    csr_dual_spmm_accum,
    csr_dual_spmm_accum_plain,
    csr_dual_spmm_plain,
    csr_pair_spmm,
    csr_pair_spmm_accum,
    csr_pair_spmm_accum_plain,
    csr_pair_spmm_plain,
    csr_scatter_accum,
    csr_scatter_accum_plain,
    csr_scatter_sum,
    csr_scatter_sum_plain,
)


def launch_counts() -> dict:
    """Launches of every sparse kernel wrapper and of the attention's edge
    kernel (``attend_grad``) since the last ``instrument.reset_counts()``,
    by name: the counter group ``"kernels"``.  MagNetConv's epilogue counts
    its own (``complex_epilogue.LAUNCHES``)."""
    return counts("kernels")


__all__ = ["bsr_matmul", "bsr_matmul_plain", "csr_dual_sddmm",
           "csr_dual_sddmm_accum", "csr_dual_sddmm_accum_plain",
           "csr_dual_sddmm_plain", "csr_dual_spmm",
           "csr_dual_spmm_accum", "csr_dual_spmm_accum_plain",
           "csr_dual_spmm_plain", "csr_pair_spmm", "csr_pair_spmm_accum",
           "csr_pair_spmm_accum_plain", "csr_pair_spmm_plain",
           "csr_scatter_accum",
           "csr_scatter_accum_plain", "csr_scatter_sum",
           "csr_scatter_sum_plain", "launch_counts"]
