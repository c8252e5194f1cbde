"""DGCN: directed GCN over the symmetrized graph and its second-order in
and out proximity graphs.

Counterpart of ``pytorch_geometric_signed_directed_tpu/nn/directed/
dgcn.py``.  The three graphs (``graph.directed_features_in_out``) arrive
as GCN-normalized Propagators (``graph.gcn_norm_propagator``), so the
convolution is the operator's apply.  Linears take flax's ``nn.Dense``
defaults from ``generator``; dropout acts only when ``training``.
"""
from typing import Optional

import torch
from torch import nn

from ...device import DeviceLike, resolve_device
from ...ops.spmm import Propagator
from ..dropout import dropout
from ..inits import linear, zeros


class DGCNConv:
    """Parameterless GCN propagation: ``DGCNConv()(x, P)`` == ``P(x)``."""

    def __call__(self, x: torch.Tensor, P: Propagator) -> torch.Tensor:
        return P(x)


class _DGCNTrunk(nn.Module):
    """Two rounds of Linear -> the three propagations, each plus a shared
    bias, concatenated -> ReLU; dropout after the second."""

    def __init__(self, num_features: int, hidden: int, dropout: float = 0.5,
                 *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dropout = dropout
        self.linear = linear(num_features, hidden, False, device, generator)
        self.bias1 = nn.Parameter(zeros((1, hidden)).to(device))
        self.linear1 = linear(3 * hidden, hidden, False, device, generator)
        self.bias2 = nn.Parameter(zeros((1, hidden)).to(device))

    def forward(self, x, P_sym, P_in, P_out, training: bool = False,
                generator: Optional[torch.Generator] = None):
        for lin, bias in ((self.linear, self.bias1),
                          (self.linear1, self.bias2)):
            x = lin(x)
            x = torch.relu(torch.cat([P(x) + bias
                                      for P in (P_sym, P_in, P_out)], dim=-1))
        return dropout(x, self.dropout, training, generator)


class DGCN_node_classification(nn.Module):
    """DGCN node classification: the three-stream trunk -> Linear ->
    log_softmax."""

    def __init__(self, num_features: int, hidden: int, label_dim: int,
                 dropout: Optional[float] = 0.5, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.trunk = _DGCNTrunk(num_features, hidden, dropout or 0.0,
                                device=device, generator=generator)
        self.linear = linear(3 * hidden, label_dim, True, device, generator)

    def forward(self, x, P_sym, P_in, P_out, training: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self.trunk(x, P_sym, P_in, P_out, training, generator)
        return torch.log_softmax(self.linear(x), dim=1)


class DGCN_link_prediction(nn.Module):
    """DGCN link prediction: the same trunk, the query edges' ends
    concatenated -> Linear -> log_softmax."""

    def __init__(self, num_features: int, hidden: int, label_dim: int,
                 dropout: Optional[float] = 0.5, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.trunk = _DGCNTrunk(num_features, hidden, dropout or 0.0,
                                device=device, generator=generator)
        self.linear = linear(6 * hidden, label_dim, True, device, generator)

    def forward(self, x, P_sym, P_in, P_out, query_edges,
                training: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self.trunk(x, P_sym, P_in, P_out, training, generator)
        x = torch.cat([x[query_edges[:, 0]], x[query_edges[:, 1]]], dim=-1)
        return torch.log_softmax(self.linear(x), dim=1)
