from .digcl_utils import drop_feature, pred_digcl_link, pred_digcl_node
from .meta_graph import meta_graph_generation
from .prob_imbalance_loss import Prob_Imbalance_Loss
from ...graph import directed_features_in_out
from ...spectral import (
    appr_directed_adj as get_appr_directed_adj,
    cal_fast_appr,
    fast_appr_power,
    magnetic_laplacian as get_magnetic_Laplacian,
    second_directed_adj as get_second_directed_adj,
)

__all__ = ["Prob_Imbalance_Loss", "cal_fast_appr", "directed_features_in_out",
           "drop_feature", "fast_appr_power", "get_appr_directed_adj",
           "get_magnetic_Laplacian", "get_second_directed_adj",
           "meta_graph_generation", "pred_digcl_link", "pred_digcl_node"]
