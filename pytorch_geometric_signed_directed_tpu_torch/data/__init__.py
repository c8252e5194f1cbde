"""Data containers and synthetic graph generators (host-side numpy)."""

from .directed_data import DirectedData
from .dsbm import DSBM
from .sdsbm import SDSBM
from .signed_data import SignedData
from .ssbm import geometric_sizes

__all__ = ["DirectedData", "DSBM", "SDSBM", "SignedData", "geometric_sizes"]
