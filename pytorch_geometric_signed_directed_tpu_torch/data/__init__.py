"""Data containers and synthetic graph generators (host-side numpy)."""

from .directed_data import DirectedData
from .dsbm import DSBM
from .sdsbm import SDSBM
from .polarized_ssbm import polarized_SSBM
from .signed_data import SignedData
from .ssbm import SSBM, geometric_sizes

__all__ = ["DirectedData", "DSBM", "SDSBM", "SSBM", "SignedData",
           "geometric_sizes", "polarized_SSBM"]
