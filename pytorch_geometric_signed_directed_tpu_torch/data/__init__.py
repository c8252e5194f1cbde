"""Synthetic graph generators (host-side numpy)."""

from .dsbm import DSBM
from .ssbm import geometric_sizes

__all__ = ["DSBM", "geometric_sizes"]
