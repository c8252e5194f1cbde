"""Single-head GAT convolution over a fixed edge structure.

Counterpart of ``pytorch_geometric_signed_directed_tpu/nn/signed/
gat_conv.py``: the PyG GATConv inside SiGAT and SDGNN, as gathers and the
attention aggregate of ``snea_conv`` on an ``AttnGraph`` with a self-loop
a node built in.
"""
from typing import Optional

import torch
from torch import nn

from ...device import DeviceLike, resolve_device
from ..inits import glorot, linear, zeros
from .snea_conv import (AttnGraph, _check_aggregate,
                        attention_softmax_aggregate, build_attention_graph)


def gat_graph(edge_index, num_nodes: int,
              device: DeviceLike = None) -> AttnGraph:
    """The edges, self-edges dropped, and a self-loop for every node (PyG
    ``add_self_loops``)."""
    return build_attention_graph([(edge_index, 0, True)], num_nodes, device)


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """``x`` where ``x >= 0``, else ``slope x`` (JAX's form: slope 1 at 0)."""
    return torch.where(x >= 0, x, slope * x)


class GATConv(nn.Module):
    """h = x W (no bias); logits = leaky_relu(h a_src at the source + h
    a_dst at the destination); softmax by destination; the weighted sum of
    h at the sources; + bias.  ``aggregate``: ``"mxu"`` (K1) or
    ``"segment"``."""

    def __init__(self, in_dim: int, out_dim: int,
                 negative_slope: float = 0.2, aggregate: str = "mxu", *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_aggregate(aggregate)
        device = resolve_device(device)
        self.negative_slope, self.aggregate = negative_slope, aggregate
        self.linear = linear(in_dim, out_dim, False, device, generator,
                             init=glorot)
        self.att_src = nn.Parameter(glorot((out_dim, 1), generator).to(device))
        self.att_dst = nn.Parameter(glorot((out_dim, 1), generator).to(device))
        self.bias = nn.Parameter(zeros((out_dim,)).to(device))

    def forward(self, x: torch.Tensor, g: AttnGraph) -> torch.Tensor:
        h = self.linear(x)
        a_src = (h @ self.att_src)[:, 0]
        a_dst = (h @ self.att_dst)[:, 0]
        logits = leaky_relu(a_src[g.src] + a_dst[g.dst], self.negative_slope)
        out = attention_softmax_aggregate(g, logits, h[g.src],
                                          self.aggregate)
        return out + self.bias
