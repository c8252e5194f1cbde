"""DiGCN: directed GCN over precomputed PPR adjacencies, and its
inception blocks.

Counterpart of ``pytorch_geometric_signed_directed_tpu/nn/directed/
digcn.py``.  The normalized adjacencies (``spectral.appr_directed_adj``,
``spectral.second_directed_adj``) arrive as Propagators built by
``graph.norm_propagator(flow='source_to_target')``.  Every Linear takes
flax's ``nn.Dense`` defaults (lecun-normal weight, zero bias) from
``generator``; dropout acts only when ``training``, drawn from the
forward's ``generator``.
"""
from typing import Optional

import torch
from torch import nn

from ...device import DeviceLike, resolve_device
from ...ops.spmm import Propagator
from ..dropout import dropout
from ..inits import linear, zeros


class DiGCNConv(nn.Module):
    """``P(x W) + bias``."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_bias: bool = True, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.linear = linear(in_channels, out_channels, False, device,
                             generator)
        self.bias = (nn.Parameter(zeros((out_channels,)).to(device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor, P: Propagator) -> torch.Tensor:
        out = P(self.linear(x))
        return out + self.bias if self.bias is not None else out


def _convs(dims, device, generator) -> nn.ModuleList:
    return nn.ModuleList([DiGCNConv(a, b, device=device, generator=generator)
                          for a, b in zip(dims[:-1], dims[1:])])


class DiGCN_node_classification(nn.Module):
    """DiGCN node classification (NeurIPS'20): two DiGCNConv layers over
    the PPR adjacency, dropout between, log_softmax."""

    def __init__(self, num_features: int, hidden: int, label_dim: int,
                 dropout: float = 0.5, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dropout = dropout
        self.convs = _convs((num_features, hidden, label_dim), device,
                            generator)

    def forward(self, x, P: Propagator, training: bool = False,
                generator: Optional[torch.Generator] = None):
        x = torch.relu(self.convs[0](x, P))
        x = dropout(x, self.dropout, training, generator)
        return torch.log_softmax(self.convs[1](x, P), dim=1)


class DiGCN_link_prediction(nn.Module):
    """DiGCN link prediction: two DiGCNConv layers, then the embeddings of
    each query edge's ends concatenated -> Linear -> log_softmax."""

    def __init__(self, num_features: int, hidden: int, label_dim: int,
                 dropout: float = 0.5, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dropout = dropout
        self.convs = _convs((num_features, hidden, hidden), device, generator)
        self.linear = linear(2 * hidden, label_dim, True, device, generator)

    def forward(self, x, P: Propagator, query_edges, training: bool = False,
                generator: Optional[torch.Generator] = None):
        x = torch.relu(self.convs[0](x, P))
        x = dropout(x, self.dropout, training, generator)
        x = torch.relu(self.convs[1](x, P))
        x = torch.cat([x[query_edges[:, 0]], x[query_edges[:, 1]]], dim=-1)
        return torch.log_softmax(self.linear(x), dim=1)


class DiGCN_Inception_Block(nn.Module):
    """x0 = Linear(x); x1 = conv(x, PPR adjacency); x2 = conv(x,
    second-order adjacency)."""

    def __init__(self, in_dim: int, out_dim: int, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.linear = linear(in_dim, out_dim, True, device, generator)
        self.convs = nn.ModuleList([
            DiGCNConv(in_dim, out_dim, device=device, generator=generator)
            for _ in range(2)])

    def forward(self, x, P1: Propagator, P2: Propagator):
        return self.linear(x), self.convs[0](x, P1), self.convs[1](x, P2)


class _Inception(nn.Module):
    """Three inception blocks fused by sum, with dropout on each branch
    and on the fused output of every block but the last."""

    def __init__(self, dims, dropout, device, generator):
        super().__init__()
        device = resolve_device(device)
        self.dropout = dropout
        self.blocks = nn.ModuleList([
            DiGCN_Inception_Block(a, b, device=device, generator=generator)
            for a, b in zip(dims[:-1], dims[1:])])

    def _trunk(self, x, P1, P2, training, generator):
        def drop(v):
            return dropout(v, self.dropout, training, generator)

        for i, block in enumerate(self.blocks):
            x0, x1, x2 = block(x, P1, P2)
            x = drop(x0) + drop(x1) + drop(x2)
            if i < len(self.blocks) - 1:
                x = drop(x)
        return x


class DiGCN_Inception_Block_node_classification(_Inception):
    """DiGCN inception node classification: blocks to hidden, hidden and
    label_dim, then log_softmax."""

    def __init__(self, num_features: int, hidden: int, label_dim: int,
                 dropout: float = 0.5, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__((num_features, hidden, hidden, label_dim), dropout,
                         device, generator)

    def forward(self, features, P1: Propagator, P2: Propagator,
                training: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self._trunk(features, P1, P2, training, generator)
        return torch.log_softmax(x, dim=1)


class DiGCN_Inception_Block_link_prediction(_Inception):
    """DiGCN inception link prediction: three blocks to hidden, then the
    query edges' ends concatenated -> Linear -> log_softmax."""

    def __init__(self, num_features: int, hidden: int, label_dim: int,
                 dropout: float = 0.5, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__((num_features, hidden, hidden, hidden), dropout,
                         device, generator)
        self.linear = linear(2 * hidden, label_dim, True,
                             resolve_device(device), generator)

    def forward(self, features, P1: Propagator, P2: Propagator, query_edges,
                training: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self._trunk(features, P1, P2, training, generator)
        x = torch.cat([x[query_edges[:, 0]], x[query_edges[:, 1]]], dim=-1)
        return torch.log_softmax(self.linear(x), dim=1)
