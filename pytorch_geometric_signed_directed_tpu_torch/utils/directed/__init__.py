from .meta_graph import meta_graph_generation
from .prob_imbalance_loss import Prob_Imbalance_Loss

__all__ = ["meta_graph_generation", "Prob_Imbalance_Loss"]
