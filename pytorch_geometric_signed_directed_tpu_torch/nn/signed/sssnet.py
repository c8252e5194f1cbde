"""SSSNET: semi-supervised signed network clustering and link prediction.

Counterpart of ``pytorch_geometric_signed_directed_tpu/nn/signed/
sssnet.py``.  Two (undirected) or four (directed) 2-layer MLPs feed SIMPA;
a linear head gives the cluster probabilities or the link classes.
Weights are xavier-uniform with gain 1.414, drawn from ``generator``;
dropout acts only when ``training``, drawn from the forward's
``generator``.
"""
from typing import Optional, Tuple

import torch
from torch import nn

from ...device import DeviceLike, resolve_device
from ...ops.spmm import Propagator
from ..dropout import dropout
from ..inits import linear, xavier_1414, zeros
from ..normalize import l2_normalize
from .simpa import SIMPA


class _SSSNETTrunk(nn.Module):
    """The input MLPs (Linear -> ReLU -> dropout -> Linear, no biases)
    and SIMPA."""

    def __init__(self, nfeat: int, hidden: int, hop: int, directed: bool,
                 dropout: float = 0.5, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dropout = dropout
        self.streams = (("w_p", "w_n") if not directed else
                        ("w_sp", "w_sn", "w_tp", "w_tn"))
        for name in self.streams:
            setattr(self, f"{name}0", linear(nfeat, hidden, False, device,
                                             generator, xavier_1414))
            setattr(self, f"{name}1", linear(hidden, hidden, False, device,
                                             generator, xavier_1414))
        self.simpa = SIMPA(hop, directed, device=device)

    def forward(self, P_p, P_n, features, P_pt=None, P_nt=None,
                training: bool = False,
                generator: Optional[torch.Generator] = None):
        xs = []
        for name in self.streams:
            x = torch.relu(getattr(self, f"{name}0")(features))
            x = dropout(x, self.dropout, training, generator)
            xs.append(getattr(self, f"{name}1")(x))
        if len(xs) == 2:
            return self.simpa(P_p, P_n, *xs)
        x_sp, x_sn, x_tp, x_tn = xs
        return self.simpa(P_p, P_n, x_sp, x_sn, P_pt, P_nt, x_tp, x_tn)


class _SSSNETBase(nn.Module):
    def __init__(self, nfeat: int, hidden: int, nclass: int, dropout: float,
                 hop: int, fill_value: float, directed: bool, bias: bool,
                 head_in: int, device: DeviceLike,
                 generator: Optional[torch.Generator]):
        super().__init__()
        device = resolve_device(device)
        self.fill_value = fill_value
        self.trunk = _SSSNETTrunk(nfeat, hidden, hop, directed, dropout,
                                  device=device, generator=generator)
        self.W_prob = nn.Parameter(
            xavier_1414((head_in, nclass), generator).to(device))
        self.bias = (nn.Parameter(zeros((nclass,)).to(device)) if bias
                     else None)

    def _head(self, z):
        out = z @ self.W_prob
        return out + self.bias if self.bias is not None else out


class SSSNET_node_clustering(_SSSNETBase):
    """SSSNET clustering (SDM'22).  Returns (l2-normalized embedding,
    log-prob, argmax clusters, prob)."""

    def __init__(self, nfeat: int, hidden: int, nclass: int,
                 dropout: float = 0.5, hop: int = 2, fill_value: float = 0.5,
                 directed: bool = False, bias: bool = True, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(nfeat, hidden, nclass, dropout, hop, fill_value,
                         directed, bias, (4 if directed else 2) * hidden,
                         device, generator)

    def forward(self, P_p: Propagator, P_n: Propagator, features,
                P_pt: Optional[Propagator] = None,
                P_nt: Optional[Propagator] = None, training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, ...]:
        z = self.trunk(P_p, P_n, features, P_pt, P_nt, training, generator)
        output = self._head(z)
        return (l2_normalize(z), torch.log_softmax(output, dim=1),
                output.argmax(dim=1), torch.softmax(output, dim=1))


class SSSNET_link_prediction(_SSSNETBase):
    """SSSNET link prediction: the embeddings of each query edge's two ends
    concatenated -> linear head -> log-prob."""

    def __init__(self, nfeat: int, hidden: int, nclass: int,
                 dropout: float = 0.5, hop: int = 2, fill_value: float = 0.5,
                 directed: bool = False, bias: bool = True, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(nfeat, hidden, nclass, dropout, hop, fill_value,
                         directed, bias, (8 if directed else 4) * hidden,
                         device, generator)

    def forward(self, P_p: Propagator, P_n: Propagator, features,
                query_edges, P_pt: Optional[Propagator] = None,
                P_nt: Optional[Propagator] = None, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        z = self.trunk(P_p, P_n, features, P_pt, P_nt, training, generator)
        x = torch.cat([z[query_edges[:, 0]], z[query_edges[:, 1]]], dim=-1)
        return torch.log_softmax(self._head(x), dim=1)
