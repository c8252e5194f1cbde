"""Host-side spectral preprocessing."""

from .magnetic import (
    MagneticPair,
    magnet_propagators,
    magnetic_laplacian,
    magnetic_signed_laplacian,
)

__all__ = ["MagneticPair", "magnet_propagators", "magnetic_laplacian",
           "magnetic_signed_laplacian"]
