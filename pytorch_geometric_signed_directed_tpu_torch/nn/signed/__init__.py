from .sgcn import (SGCN, prepare_sgcn_inputs, sgcn_dual_propagator,
                   split_signed_edges)
from .sgcn_conv import SGCNConv
from .simpa import SIMPA
from .sssnet import SSSNET_link_prediction, SSSNET_node_clustering

__all__ = ["SGCN", "SGCNConv", "SIMPA", "SSSNET_link_prediction",
           "SSSNET_node_clustering", "prepare_sgcn_inputs",
           "sgcn_dual_propagator", "split_signed_edges"]
