"""Host-side utilities: meta-graphs, node and link splits, samplers."""

from .directed import meta_graph_generation
from .general import link_class_split, node_class_split
from .signed import negative_sampling, structured_negative_sampling

__all__ = ["link_class_split", "meta_graph_generation", "negative_sampling",
           "node_class_split", "structured_negative_sampling"]
