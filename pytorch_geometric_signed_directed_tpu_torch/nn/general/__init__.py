from .conv_base import Conv_Base
from .msconv import MSConv
from .msgnn import MSGNN_link_prediction, MSGNN_node_classification

__all__ = ["Conv_Base", "MSConv", "MSGNN_link_prediction",
           "MSGNN_node_classification"]
