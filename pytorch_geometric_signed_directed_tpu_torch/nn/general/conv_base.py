"""Conv_Base: row-normalized, parameterless propagation.

Counterpart of ``pytorch_geometric_signed_directed_tpu/nn/general/
conv_base.py``.  The normalization D^-1 (A + fill I) is frozen into a
Propagator by ``graph.rw_norm_propagator``; the layer only applies it.
"""
from ...graph import rw_norm_propagator  # noqa: F401  (public re-export)
from ...ops.spmm import Propagator


class Conv_Base:
    """``Conv_Base()(x, P)`` == ``P(x)`` with P from rw_norm_propagator."""

    def __init__(self, fill_value: float = 0.5):
        self.fill_value = fill_value

    def __call__(self, x, P: Propagator):
        return P(x)
