from .complex_relu import complex_relu, complex_relu_layer
from .magnet import MagNet_link_prediction, MagNet_node_classification
from .magnet_conv import MagNetConv, chebyshev_stack, dual_chebyshev_stacks

__all__ = ["complex_relu", "complex_relu_layer", "MagNet_link_prediction",
           "MagNet_node_classification", "MagNetConv", "chebyshev_stack",
           "dual_chebyshev_stacks"]
