"""Model layers as torch.nn.Modules."""

from .directed import (
    MagNet_link_prediction,
    MagNet_node_classification,
    MagNetConv,
    complex_relu,
    complex_relu_layer,
)
from .general import MSConv, MSGNN_link_prediction, MSGNN_node_classification
from .normalize import l2_normalize

__all__ = ["MagNet_link_prediction", "MagNet_node_classification",
           "MagNetConv", "MSConv", "MSGNN_link_prediction",
           "MSGNN_node_classification", "complex_relu", "complex_relu_layer",
           "l2_normalize"]
