"""Single-head GAT convolution over a fixed edge structure.

Counterpart of ``pytorch_geometric_signed_directed_tpu/nn/signed/
gat_conv.py``: the PyG GATConv inside SiGAT and SDGNN, as gathers and the
attention aggregate of ``snea_conv`` on an ``AttnGraph`` with a self-loop
a node built in, or ``parallel.sharded_attention_apply`` on a sharded one
(the graph's ``attend``).
"""
from typing import Optional

import torch
from torch import nn

from ... import instrument
from ...device import DeviceLike, resolve_device
from ..inits import glorot, linear, zeros
from .snea_conv import AttnGraph, _check_aggregate, build_attention_graph


def gat_graph(edge_index, num_nodes: int,
              device: DeviceLike = None) -> AttnGraph:
    """The edges, self-edges dropped, and a self-loop for every node (PyG
    ``add_self_loops``)."""
    return build_attention_graph([(edge_index, 0, True)], num_nodes,
                                 device=device)


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """``x`` where ``x >= 0``, else ``slope x`` (JAX's form: slope 1 at 0)."""
    return torch.where(x >= 0, x, slope * x)


class GATConv(nn.Module):
    """h = x W (no bias); logits = leaky_relu(h a_src at the source + h
    a_dst at the destination); softmax by destination; the weighted sum of
    h at the sources; + bias.  ``aggregate``: ``"mxu"`` (K1) or
    ``"segment"``.  ``motif``: its motif graph's index in its model, an
    attribute of its span ``pgsd.nn.gat_conv``."""

    def __init__(self, in_dim: int, out_dim: int,
                 negative_slope: float = 0.2, aggregate: str = "mxu", *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 motif: Optional[int] = None):
        super().__init__()
        _check_aggregate(aggregate)
        device = resolve_device(device)
        self.negative_slope, self.aggregate = negative_slope, aggregate
        self.linear = linear(in_dim, out_dim, False, device, generator,
                             init=glorot)
        self.att_src = nn.Parameter(glorot((out_dim, 1), generator).to(device))
        self.att_dst = nn.Parameter(glorot((out_dim, 1), generator).to(device))
        self.bias = nn.Parameter(zeros((out_dim,)).to(device))
        self.motif = motif

    def _span_attrs(self, x, g) -> dict:
        """The span's attributes: the graph's rows and edges (self-loops
        included; 0 on a sharded graph), the lanes of its K1 sum (1 +
        out) and the motif (-1 where none was set)."""
        return dict(rows=g.num_nodes,
                    nnz=int(g.src.numel()) if isinstance(g, AttnGraph)
                    else 0, width=1 + self.linear.out_features,
                    motif=-1 if self.motif is None else self.motif)

    def _edges(self, src, dst, edge_p, h, a_src, a_dst):
        """The logits leaky_relu(a_src at the source + a_dst at the
        destination) and the messages h at the sources."""
        return (leaky_relu(a_src[src] + a_dst[dst], self.negative_slope),
                h[src])

    @instrument.layer("nn.gat_conv", attrs=_span_attrs)
    def forward(self, x: torch.Tensor, g: AttnGraph) -> torch.Tensor:
        """``g``: an ``AttnGraph`` or a ``parallel.ShardedAttnGraph`` (K1
        a shard, whatever the aggregate)."""
        h = self.linear(x)
        a_src = (h @ self.att_src)[:, 0]
        a_dst = (h @ self.att_dst)[:, 0]
        return g.attend(self._edges, (h, a_src, a_dst),
                        self.aggregate) + self.bias
