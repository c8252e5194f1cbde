"""Model layers as torch.nn.Modules."""

from .directed import (
    MagNet_link_prediction,
    MagNet_node_classification,
    MagNetConv,
    complex_relu,
    complex_relu_layer,
)

__all__ = ["MagNet_link_prediction", "MagNet_node_classification",
           "MagNetConv", "complex_relu", "complex_relu_layer"]
