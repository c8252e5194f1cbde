"""SNEA: signed network embedding via attention.

Counterpart of ``pytorch_geometric_signed_directed_tpu/nn/signed/snea.py``:
the SGCN scaffold over SNEAConv layers with a Linear head; the loss is
Link_Sign_Entropy + lamb * sign_structure (lamb = 4); the input embedding
is trainable by default.
"""
from typing import Optional

import numpy as np
import torch
from torch import nn

from ...device import DeviceLike, resolve_device
from ...spectral.features import create_spectral_features
from ...utils.signed.link_sign_loss import Link_Sign_Entropy_Loss
from ..inits import linear
from .sgcn import (entropy_and_structure_loss, register_embedding,
                   split_signed_edges)
from .snea_conv import SNEAConv, snea_graphs


def prepare_snea_inputs(node_num: int, edge_index_s, in_dim: int = 20,
                        init_emb: Optional[np.ndarray] = None,
                        device: DeviceLike = None):
    """(pos_edge_index, neg_edge_index, init_emb, (g_pos, g_neg, g_cat)):
    the split edges, the input embedding (``create_spectral_features``
    unless given) and the three attention graphs on ``device``."""
    device = resolve_device(device)
    pos_edge_index, neg_edge_index = split_signed_edges(edge_index_s)
    if init_emb is None:
        init_emb = create_spectral_features(pos_edge_index, neg_edge_index,
                                            node_num, in_dim, device=device)
    graphs = snea_graphs(pos_edge_index, neg_edge_index, node_num, device)
    return pos_edge_index, neg_edge_index, init_emb, graphs


class SNEA(nn.Module):
    """SNEA (AAAI'20): a first SNEAConv from the input embedding, then
    ``layer_num - 1`` more, each followed by tanh, then tanh(Linear).
    ``aggregate``: ``"mxu"`` (K1) or ``"segment"`` in every layer."""

    def __init__(self, node_num: int, in_dim: int = 20, out_dim: int = 20,
                 layer_num: int = 2, lamb: float = 4.0,
                 init_emb_grad: bool = True,
                 init_emb: Optional[np.ndarray] = None,
                 aggregate: str = "mxu", *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if init_emb is None:
            raise ValueError("SNEA needs init_emb; prepare_snea_inputs "
                             "builds the spectral one")
        self.node_num, self.lamb = node_num, lamb
        register_embedding(self, init_emb, init_emb_grad, device)
        half = out_dim // 2
        kw = dict(aggregate=aggregate, device=device, generator=generator)
        self.conv1 = SNEAConv(in_dim, half, first_aggr=True, **kw)
        self.convs = nn.ModuleList([
            SNEAConv(half, half, first_aggr=False, **kw)
            for _ in range(layer_num - 1)])
        self.weight = linear(2 * half, out_dim, True, device, generator)
        self.lsp_loss = Link_Sign_Entropy_Loss(out_dim, device=device,
                                               generator=generator)

    def forward(self, graphs) -> torch.Tensor:
        g_pos, g_neg, g_cat = graphs
        z = torch.tanh(self.conv1(self.x, g_pos, g_neg, g_cat))
        for conv in self.convs:
            z = torch.tanh(conv(z, g_pos, g_neg, g_cat))
        return torch.tanh(self.weight(z))

    def loss(self, graphs, pos_edge_index, neg_edge_index, none_edge_index,
             pos_triplets, neg_triplets) -> torch.Tensor:
        """nll + lamb * the structure loss, on the samples of
        ``utils.signed.negative_sampling`` and
        ``structured_negative_sampling`` (numpy arrays or tensors)."""
        return entropy_and_structure_loss(
            self(graphs), self.lsp_loss, self.lamb, pos_edge_index,
            neg_edge_index, none_edge_index, pos_triplets, neg_triplets)
