"""The yardstick's arithmetic: one H100's published peaks, the least time
a piece of work needs on it, and the bytes and operations of a sparse
operator apply, counted from the operator's math alone.

An apply ``out = A @ x`` (or a dual apply, two value arrays over one
structure, ``[A x_a | B x_b]``) reads its row pointers, its column ids,
its value arrays and x once and writes out once; it adds one product a
nonzero and lane.  Nothing comes from a layout: blocks, cut rows, hot
columns and pieces are not counted, so the same apply counts the same
work whatever implements it.
"""
from dataclasses import dataclass

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
F32_FLOPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
INDEX_BYTES = 4              # int32 row pointers and column ids
VALUE_BYTES = 4              # float32 operator values
OUT_BYTES = 4                # float32 output


@dataclass(frozen=True)
class Apply:
    """One sparse apply: an operator of ``rows`` x ``cols`` with ``nnz``
    entries and ``values`` value arrays (1 a single operator, 2 a dual),
    applied to ``width`` lanes of ``elem``-byte messages."""

    rows: int
    cols: int
    nnz: int
    values: int
    width: int
    elem: int = 4


def apply_bytes(a: Apply) -> int:
    return (INDEX_BYTES * (a.rows + 1)
            + (INDEX_BYTES + VALUE_BYTES * a.values) * a.nnz
            + a.elem * a.cols * a.width + OUT_BYTES * a.rows * a.width)


def apply_flops(a: Apply) -> int:
    return 2 * a.nnz * a.width


def bound(nbytes: float, flops: float):
    """(least milliseconds, "bytes" or "operations"): the larger of bytes
    over the memory rate and operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def apply_bound_s(a: Apply) -> float:
    """The least seconds one apply needs."""
    return bound(apply_bytes(a), apply_flops(a))[0] / 1e3


def matmul_flops(m: int, k: int, n: int) -> int:
    """[m, k] @ [k, n]."""
    return 2 * m * k * n
