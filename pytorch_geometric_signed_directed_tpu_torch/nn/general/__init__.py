from .msconv import MSConv
from .msgnn import MSGNN_link_prediction, MSGNN_node_classification

__all__ = ["MSConv", "MSGNN_link_prediction", "MSGNN_node_classification"]
