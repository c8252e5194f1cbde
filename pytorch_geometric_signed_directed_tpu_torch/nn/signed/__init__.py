from .gat_conv import GATConv, gat_graph
from .motif_stack import (MotifGATStack, MotifStackGraph, build_motif_stack,
                          motif_attend)
from .motifs import sdgnn_edge_lists, sigat_edge_lists
from .sdgnn import SDGNN, SDRLayer, prepare_sdgnn_inputs
from .sgcn import (SGCN, prepare_sgcn_inputs, sgcn_dual_propagator,
                   split_signed_edges)
from .sgcn_conv import SGCNConv
from .sigat import SiGAT, prepare_sigat_inputs
from .simpa import SIMPA
from .snea import SNEA, prepare_snea_inputs
from .snea_conv import (AttnGraph, SNEAConv, attention_softmax_aggregate,
                        attention_softmax_aggregate_pair,
                        build_attention_graph, snea_graphs)
from .sssnet import SSSNET_link_prediction, SSSNET_node_clustering

__all__ = ["AttnGraph", "GATConv", "MotifGATStack", "MotifStackGraph",
           "SDGNN", "SDRLayer", "SGCN", "SGCNConv", "SIMPA", "SNEA",
           "SNEAConv", "SSSNET_link_prediction", "SSSNET_node_clustering",
           "SiGAT", "attention_softmax_aggregate",
           "attention_softmax_aggregate_pair", "build_attention_graph",
           "build_motif_stack", "gat_graph", "motif_attend",
           "prepare_sdgnn_inputs", "prepare_sgcn_inputs",
           "prepare_sigat_inputs", "prepare_snea_inputs",
           "sdgnn_edge_lists", "sgcn_dual_propagator", "sigat_edge_lists",
           "snea_graphs", "split_signed_edges"]
