"""Host-side spectral preprocessing and the trainable-q templates."""

from .magnetic import (
    MagneticPair,
    MagneticTemplate,
    magnet_operator_arrays,
    magnet_propagators,
    magnetic_laplacian,
    magnetic_pair,
    magnetic_signed_laplacian,
    magnetic_template,
    template_dual,
    template_dual_apply,
    template_propagators,
)

__all__ = ["MagneticPair", "MagneticTemplate", "magnet_operator_arrays",
           "magnet_propagators", "magnetic_laplacian", "magnetic_pair",
           "magnetic_signed_laplacian", "magnetic_template", "template_dual",
           "template_dual_apply", "template_propagators"]
