from .complex_relu import complex_relu, complex_relu_layer
from .digcl import DiGCL, DiGCL_Encoder
from .dgcn import DGCN_link_prediction, DGCN_node_classification, DGCNConv
from .digcn import (
    DiGCN_Inception_Block,
    DiGCN_Inception_Block_link_prediction,
    DiGCN_Inception_Block_node_classification,
    DiGCN_link_prediction,
    DiGCN_node_classification,
    DiGCNConv,
)
from .dimpa import DIGRAC_node_clustering, DIMPA
from .magnet import MagNet_link_prediction, MagNet_node_classification
from .magnet_conv import MagNetConv, chebyshev_stack, dual_chebyshev_stacks

__all__ = ["complex_relu", "complex_relu_layer", "DGCN_link_prediction",
           "DGCN_node_classification", "DGCNConv", "DiGCL",
           "DiGCL_Encoder", "DiGCN_Inception_Block",
           "DiGCN_Inception_Block_link_prediction",
           "DiGCN_Inception_Block_node_classification",
           "DiGCN_link_prediction", "DiGCN_node_classification", "DiGCNConv",
           "DIGRAC_node_clustering", "DIMPA", "MagNet_link_prediction",
           "MagNet_node_classification", "MagNetConv", "chebyshev_stack",
           "dual_chebyshev_stacks"]
