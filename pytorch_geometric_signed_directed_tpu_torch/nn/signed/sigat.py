"""SiGAT: signed graph attention over 38 motif graphs.

Counterpart of ``pytorch_geometric_signed_directed_tpu/nn/signed/
sigat.py``.  The motif edge lists are built on the host
(``motifs.sigat_edge_lists``); each motif graph has its own GATConv, or
all 38 ride one ``MotifGATStack`` (``fused``); the embeddings are
concatenated and pass a 2-layer MLP; the loss is link_sign_product_loss.
"""
from typing import Optional

import numpy as np
import torch
from torch import nn

from ...device import DeviceLike, resolve_device
from ...spectral.features import create_spectral_features
from ...utils.signed.link_sign_loss import link_sign_product_loss
from ..inits import kaiming_normal, linear
from .gat_conv import GATConv, gat_graph
from .motif_stack import MotifGATStack, MotifStackGraph, build_motif_stack
from .motifs import sigat_edge_lists
from .sgcn import register_embedding, split_signed_edges


def prepare_sigat_inputs(node_num: int, edge_index_s, in_dim: int = 20,
                         init_emb: Optional[np.ndarray] = None,
                         fused: bool = False, device: DeviceLike = None):
    """(pos_edge_index, neg_edge_index, init_emb, graphs): the split
    edges, the input embedding (``create_spectral_features`` unless given)
    and the 38 motif graphs, as a list of ``AttnGraph``s or, with
    ``fused``, one ``MotifStackGraph`` over 38 N rows."""
    device = resolve_device(device)
    pos_edge_index, neg_edge_index = split_signed_edges(edge_index_s)
    if init_emb is None:
        init_emb = create_spectral_features(pos_edge_index, neg_edge_index,
                                            node_num, in_dim)
    edge_lists = sigat_edge_lists(edge_index_s, node_num)
    if fused:
        graphs = build_motif_stack(edge_lists, node_num, device)
    else:
        graphs = [gat_graph(e, node_num, device) for e in edge_lists]
    return pos_edge_index, neg_edge_index, init_emb, graphs


def mlp_linear(in_dim, out_dim, device, generator) -> nn.Linear:
    """SiGAT's MLP layers: kaiming-normal weight, bias 0.01."""
    layer = linear(in_dim, out_dim, True, device, generator,
                   init=kaiming_normal)
    with torch.no_grad():
        layer.bias.fill_(0.01)
    return layer


class SiGAT(nn.Module):
    """SiGAT (ICANN'19): one GAT per motif graph -> [x | motif outputs]
    -> Linear -> tanh -> Linear.  ``fused``: the motif GATs as one
    ``MotifGATStack`` (its graphs a ``MotifStackGraph``), else one GATConv
    a motif (``aggs``; ``aggregate`` ``"mxu"`` or ``"segment"``)."""

    def __init__(self, node_num: int, num_graphs: int = 38, in_dim: int = 20,
                 out_dim: int = 20, init_emb_grad: bool = True,
                 init_emb: Optional[np.ndarray] = None, fused: bool = False,
                 aggregate: str = "mxu", *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if init_emb is None:
            raise ValueError("SiGAT needs init_emb; prepare_sigat_inputs "
                             "builds the spectral one")
        self.node_num, self.fused = node_num, fused
        register_embedding(self, init_emb, init_emb_grad, device)
        if fused:
            self.agg_stack = MotifGATStack(in_dim, out_dim, num_graphs,
                                           device=device, generator=generator)
        else:
            self.aggs = nn.ModuleList([
                GATConv(in_dim, out_dim, aggregate=aggregate, device=device,
                        generator=generator) for _ in range(num_graphs)])
        width = in_dim + num_graphs * out_dim
        self.mlp1 = mlp_linear(width, out_dim, device, generator)
        self.mlp2 = mlp_linear(out_dim, out_dim, device, generator)

    def forward(self, graphs) -> torch.Tensor:
        x = self.x
        if self.fused != isinstance(graphs, MotifStackGraph):
            raise TypeError("a fused SiGAT takes a MotifStackGraph, an "
                            "unfused one a list of AttnGraphs")
        if self.fused:
            combined = MotifGATStack.concat(x, self.agg_stack(x, graphs))
        else:
            combined = torch.cat(
                [x] + [agg(x, g) for agg, g in zip(self.aggs, graphs)], dim=1)
        return self.mlp2(torch.tanh(self.mlp1(combined)))

    def loss(self, graphs, pos_edge_index, neg_edge_index) -> torch.Tensor:
        z = self(graphs)
        return link_sign_product_loss(
            z, torch.as_tensor(pos_edge_index, device=z.device),
            torch.as_tensor(neg_edge_index, device=z.device))
