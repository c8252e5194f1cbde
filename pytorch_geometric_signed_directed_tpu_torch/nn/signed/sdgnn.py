"""SDGNN: signed directed GNN with motif attention and a three-part loss.

Counterpart of ``pytorch_geometric_signed_directed_tpu/nn/signed/
sdgnn.py``.  Each SDRLayer runs one GAT a motif graph (4 of them) or one
``MotifGATStack`` (``fused``), concatenates [x | motif outputs] and
applies a 2-layer MLP; the loss adds the sign, direction and triangle
losses.
"""
from typing import Optional

import numpy as np
import torch
from torch import nn

from ... import instrument
from ...device import DeviceLike, resolve_device
from ...spectral.features import create_spectral_features
from ...utils.signed.link_sign_loss import (PlannedEdges,
                                            Sign_Direction_Loss,
                                            Sign_Triangle_Loss,
                                            sign_product_entropy_loss)
from ..inits import kaiming_normal, linear
from .gat_conv import GATConv, gat_graph
from .motif_stack import MotifGATStack, MotifStackGraph, build_motif_stack
from .motifs import sdgnn_edge_lists
from .sgcn import register_embedding, split_signed_edges


def prepare_sdgnn_inputs(node_num: int, edge_index_s, in_dim: int = 20,
                         init_emb: Optional[np.ndarray] = None,
                         fused: bool = False, device: DeviceLike = None):
    """(pos_edge_index, neg_edge_index, init_emb, graphs, w_pos, w_neg):
    the split edges, the input embedding, the 4 motif graphs (a list of
    ``AttnGraph``s, or with ``fused`` one ``MotifStackGraph``) and the
    triangle weights of the positive and negative edges (float32)."""
    device = resolve_device(device)
    pos_edge_index, neg_edge_index = split_signed_edges(edge_index_s)
    if init_emb is None:
        init_emb = create_spectral_features(pos_edge_index, neg_edge_index,
                                            node_num, in_dim, device=device)
    edge_lists, tri_weight = sdgnn_edge_lists(edge_index_s, node_num)
    if fused:
        graphs = build_motif_stack(edge_lists, node_num, device)
    else:
        graphs = [gat_graph(e, node_num, device) for e in edge_lists]
    w_pos = np.asarray(
        tri_weight[pos_edge_index[0], pos_edge_index[1]]).ravel()
    w_neg = np.asarray(
        tri_weight[neg_edge_index[0], neg_edge_index[1]]).ravel()
    return (pos_edge_index, neg_edge_index, init_emb, graphs,
            w_pos.astype(np.float32), w_neg.astype(np.float32))


class SDRLayer(nn.Module):
    """One GAT a motif graph (``aggs``) or one ``MotifGATStack``
    (``fused``), then [x | motif outputs] -> Linear -> tanh -> Linear
    (kaiming-normal weights, zero biases)."""

    def __init__(self, in_dim: int, out_dim: int, num_graphs: int = 4,
                 fused: bool = False, aggregate: str = "mxu", *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.fused = fused
        if fused:
            self.agg_stack = MotifGATStack(in_dim, out_dim, num_graphs,
                                           device=device, generator=generator)
        else:
            self.aggs = nn.ModuleList([
                GATConv(in_dim, out_dim, aggregate=aggregate, device=device,
                        generator=generator, motif=i)
                for i in range(num_graphs)])
        self.linear = linear(in_dim + num_graphs * out_dim, out_dim, True,
                             device, generator, init=kaiming_normal)
        self.linear1 = linear(out_dim, out_dim, True, device, generator,
                              init=kaiming_normal)

    @instrument.layer("nn.sdr_layer")
    def forward(self, x: torch.Tensor, graphs) -> torch.Tensor:
        if self.fused != isinstance(graphs, MotifStackGraph):
            raise TypeError("a fused SDRLayer takes a MotifStackGraph, an "
                            "unfused one a list of AttnGraphs")
        if self.fused:
            combined = MotifGATStack.concat(x, self.agg_stack(x, graphs))
        else:
            combined = torch.cat(
                [x] + [agg(x, g) for agg, g in zip(self.aggs, graphs)], dim=1)
        return self.linear1(torch.tanh(self.linear(combined)))


class SDGNN(nn.Module):
    """SDGNN (AAAI'21): ``layer_num`` SDRLayers over 4 motif graphs; loss
    = sign + lamb_d * direction + lamb_t * triangle."""

    def __init__(self, node_num: int, in_dim: int = 20, out_dim: int = 20,
                 layer_num: int = 2, lamb_d: float = 5.0, lamb_t: float = 1.0,
                 init_emb_grad: bool = True,
                 init_emb: Optional[np.ndarray] = None, num_graphs: int = 4,
                 fused: bool = False, aggregate: str = "mxu", *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if init_emb is None:
            raise ValueError("SDGNN needs init_emb; prepare_sdgnn_inputs "
                             "builds the spectral one")
        self.node_num, self.lamb_d, self.lamb_t = node_num, lamb_d, lamb_t
        register_embedding(self, init_emb, init_emb_grad, device)
        kw = dict(num_graphs=num_graphs, fused=fused, aggregate=aggregate,
                  device=device, generator=generator)
        self.layers = nn.ModuleList([
            SDRLayer(in_dim if i == 0 else out_dim, out_dim, **kw)
            for i in range(layer_num)])
        self.loss_direction = Sign_Direction_Loss(out_dim, device=device,
                                                  generator=generator)
        self.loss_tri = Sign_Triangle_Loss(out_dim, device=device,
                                           generator=generator)

    @instrument.layer("nn.sdgnn")
    def forward(self, graphs) -> torch.Tensor:
        x = self.x
        for layer in self.layers:
            x = layer(x, graphs)
        return x

    def loss(self, graphs, pos_edge_index, neg_edge_index, w_pos,
             w_neg) -> torch.Tensor:
        """The edge lists as arrays, tensors or ``PlannedEdges``
        (``plan_edges``: planned once, their gathers' backward on K1)."""
        z = self(graphs)

        def dev(a):
            if isinstance(a, PlannedEdges):
                return a
            return torch.as_tensor(a, device=z.device)

        pos, neg = dev(pos_edge_index), dev(neg_edge_index)
        return (sign_product_entropy_loss(z, pos, neg)
                + self.lamb_d * self.loss_direction(z, pos, neg)
                + self.lamb_t * self.loss_tri(z, pos, neg, dev(w_pos),
                                              dev(w_neg)))
