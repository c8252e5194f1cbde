"""Hand-written CUDA kernels for Hopper, built with nvcc at first use."""

from . import attend_grad, bsr_spmm, dual_sddmm, scatter_csr
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
    kernel (``attend_grad``) since the last reset, by name.  MagNetConv's
    epilogue counts its own (``complex_epilogue.LAUNCHES``)."""
    return {**scatter_csr.LAUNCHES, **bsr_spmm.LAUNCHES,
            **dual_sddmm.LAUNCHES, **attend_grad.LAUNCHES}


def reset_launch_counts() -> None:
    scatter_csr.reset_launch_counts()
    bsr_spmm.reset_launch_counts()
    dual_sddmm.reset_launch_counts()
    attend_grad.reset_launch_counts()


__all__ = ["bsr_matmul", "bsr_matmul_plain", "csr_dual_sddmm",
           "csr_dual_sddmm_accum", "csr_dual_sddmm_accum_plain",
           "csr_dual_sddmm_plain", "csr_dual_spmm",
           "csr_dual_spmm_accum", "csr_dual_spmm_accum_plain",
           "csr_dual_spmm_plain", "csr_pair_spmm", "csr_pair_spmm_accum",
           "csr_pair_spmm_accum_plain", "csr_pair_spmm_plain",
           "csr_scatter_accum",
           "csr_scatter_accum_plain", "csr_scatter_sum",
           "csr_scatter_sum_plain", "launch_counts", "reset_launch_counts"]
