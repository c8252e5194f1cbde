"""Host-side spectral preprocessing (magnetic Laplacians, PPR adjacencies,
Hermitian features) and the trainable-q templates."""

from .appr import (
    appr_directed_adj,
    cal_fast_appr,
    fast_appr_power,
    second_directed_adj,
)
from .features import (create_spectral_features, hermitian_features,
                       signed_laplacian_eig_features,
                       spectral_adjacency_reg_features)
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

__all__ = ["MagneticPair", "MagneticTemplate", "appr_directed_adj",
           "cal_fast_appr", "create_spectral_features",
           "fast_appr_power", "hermitian_features",
           "magnet_operator_arrays", "magnet_propagators",
           "magnetic_laplacian", "magnetic_pair",
           "magnetic_signed_laplacian", "magnetic_template",
           "second_directed_adj", "signed_laplacian_eig_features",
           "spectral_adjacency_reg_features", "template_dual",
           "template_dual_apply", "template_propagators"]
