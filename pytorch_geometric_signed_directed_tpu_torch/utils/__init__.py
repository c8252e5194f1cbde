"""Host-side utilities: meta-graphs, node and link splits, samplers, the
imbalance loss and clustering scores."""

from .directed import Prob_Imbalance_Loss, meta_graph_generation
from .general import adjusted_rand_score, link_class_split, node_class_split
from .signed import negative_sampling, structured_negative_sampling

__all__ = ["Prob_Imbalance_Loss", "adjusted_rand_score", "link_class_split",
           "meta_graph_generation", "negative_sampling", "node_class_split",
           "structured_negative_sampling"]
