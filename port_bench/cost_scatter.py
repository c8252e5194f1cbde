"""The yardstick of a segment sum (K1 ``csr_scatter_sum``): its bytes and
operations, counted from its shapes alone, and the least time it needs
on one H100 (``cost``'s peaks).

A segment sum of ``nnz`` row-ordered messages of ``width`` lanes into
``rows`` rows reads its row pointers and the [nnz, width] messages once
and writes the [rows, width] output once; it adds one message lane a
message.  Nothing comes from a plan: cut rows, row blocks and pieces are
not counted.
"""
from dataclasses import dataclass

from port_bench import cost


@dataclass(frozen=True)
class Scatter:
    """One segment sum: ``nnz`` messages of ``width`` lanes of ``elem``
    bytes into ``rows`` rows."""

    rows: int
    nnz: int
    width: int
    elem: int = 4


def scatter_bytes(s: Scatter) -> int:
    return (cost.INDEX_BYTES * (s.rows + 1) + s.elem * s.nnz * s.width
            + cost.OUT_BYTES * s.rows * s.width)


def scatter_flops(s: Scatter) -> int:
    return s.nnz * s.width


def scatter_bound_s(s: Scatter) -> float:
    """The least seconds one segment sum needs."""
    return cost.bound(scatter_bytes(s), scatter_flops(s))[0] / 1e3
