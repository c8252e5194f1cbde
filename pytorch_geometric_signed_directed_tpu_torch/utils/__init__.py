"""Host-side utilities: meta-graphs, node and link splits, samplers, the
imbalance, balanced-cut, link-sign and triplet losses, clustering scores,
DiGCL's feature dropout and the logistic evaluation of embeddings."""

from .directed import (
    Prob_Imbalance_Loss, cal_fast_appr, directed_features_in_out,
    drop_feature, fast_appr_power, get_appr_directed_adj,
    get_magnetic_Laplacian, get_second_directed_adj, meta_graph_generation,
    pred_digcl_link, pred_digcl_node)
from .general import (
    Triplet_Loss_InnerProduct, adjusted_rand_score, extract_network,
    get_magnetic_signed_Laplacian, in_out_degree, link_class_split,
    link_sign_direction_prediction_logistic_function,
    link_sign_prediction_logistic_function, node_class_split,
    scipy_sparse_to_torch_coo, scipy_sparse_to_torch_sparse,
    triplet_loss_node_classification)
from .signed import (Link_Sign_Entropy_Loss, Link_Sign_Product_Loss,
                     Prob_Balanced_Normalized_Loss, Prob_Balanced_Ratio_Loss,
                     Sign_Direction_Loss, Sign_Product_Entropy_Loss,
                     Sign_Structure_Loss, Sign_Triangle_Loss, Unhappy_Ratio,
                     negative_sampling, structured_negative_sampling)
from ..spectral import create_spectral_features

__all__ = ["Link_Sign_Entropy_Loss", "Link_Sign_Product_Loss",
           "Prob_Balanced_Normalized_Loss", "Prob_Balanced_Ratio_Loss",
           "Prob_Imbalance_Loss", "Sign_Direction_Loss",
           "Sign_Product_Entropy_Loss", "Sign_Structure_Loss",
           "Sign_Triangle_Loss", "Triplet_Loss_InnerProduct", "Unhappy_Ratio",
           "adjusted_rand_score", "cal_fast_appr",
           "create_spectral_features", "directed_features_in_out",
           "drop_feature", "extract_network", "fast_appr_power",
           "get_appr_directed_adj", "get_magnetic_Laplacian",
           "get_magnetic_signed_Laplacian", "get_second_directed_adj",
           "in_out_degree", "link_class_split",
           "link_sign_direction_prediction_logistic_function",
           "link_sign_prediction_logistic_function", "meta_graph_generation",
           "negative_sampling", "node_class_split",
           "pred_digcl_link", "pred_digcl_node",
           "scipy_sparse_to_torch_coo", "scipy_sparse_to_torch_sparse",
           "structured_negative_sampling",
           "triplet_loss_node_classification"]
