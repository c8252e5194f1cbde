"""Host-side utilities: meta-graphs, node and link splits, samplers, the
imbalance, balanced-cut, link-sign and triplet losses and clustering
scores."""

from .directed import Prob_Imbalance_Loss, meta_graph_generation
from .general import (Triplet_Loss_InnerProduct, adjusted_rand_score,
                      extract_network, link_class_split, node_class_split)
from .signed import (Link_Sign_Entropy_Loss, Prob_Balanced_Normalized_Loss,
                     Prob_Balanced_Ratio_Loss, Unhappy_Ratio,
                     negative_sampling, structured_negative_sampling)

__all__ = ["Link_Sign_Entropy_Loss", "Prob_Balanced_Normalized_Loss",
           "Prob_Balanced_Ratio_Loss", "Prob_Imbalance_Loss",
           "Triplet_Loss_InnerProduct", "Unhappy_Ratio",
           "adjusted_rand_score", "extract_network", "link_class_split",
           "meta_graph_generation", "negative_sampling", "node_class_split",
           "structured_negative_sampling"]
