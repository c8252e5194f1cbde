"""Model layers as torch.nn.Modules."""

from .directed import (
    DGCN_link_prediction,
    DGCN_node_classification,
    DGCNConv,
    DIGRAC_node_clustering,
    DIMPA,
    DiGCN_Inception_Block,
    DiGCN_Inception_Block_link_prediction,
    DiGCN_Inception_Block_node_classification,
    DiGCN_link_prediction,
    DiGCN_node_classification,
    DiGCNConv,
    MagNet_link_prediction,
    MagNet_node_classification,
    MagNetConv,
    complex_relu,
    complex_relu_layer,
)
from .general import (Conv_Base, MSConv, MSGNN_link_prediction,
                      MSGNN_node_classification)
from .normalize import l2_normalize
from .signed import (SDGNN, SGCN, SNEA, GATConv, SGCNConv, SIMPA, SiGAT,
                     SNEAConv, SSSNET_link_prediction,
                     SSSNET_node_clustering)

__all__ = ["Conv_Base", "DGCN_link_prediction", "DGCN_node_classification",
           "DGCNConv", "DIGRAC_node_clustering", "DIMPA",
           "DiGCN_Inception_Block", "DiGCN_Inception_Block_link_prediction",
           "DiGCN_Inception_Block_node_classification",
           "DiGCN_link_prediction", "DiGCN_node_classification", "DiGCNConv",
           "MagNet_link_prediction", "MagNet_node_classification",
           "MagNetConv", "MSConv", "MSGNN_link_prediction",
           "MSGNN_node_classification", "GATConv", "SDGNN", "SGCN",
           "SGCNConv", "SIMPA", "SNEA", "SNEAConv", "SiGAT",
           "SSSNET_link_prediction", "SSSNET_node_clustering",
           "complex_relu", "complex_relu_layer", "l2_normalize"]
