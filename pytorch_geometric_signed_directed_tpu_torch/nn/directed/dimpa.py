"""DIMPA and DIGRAC: directed mixed-path aggregation and clustering.

Counterpart of ``pytorch_geometric_signed_directed_tpu/nn/directed/
dimpa.py``.  The two walk operators (source walks over A, target walks
over A^T, each row-normalized with a self-loop fill) arrive as
Propagators from ``graph.rw_norm_propagator``, or fused into one
DualPropagator by ``graph.rw_norm_dual_propagator``.
"""
from typing import Optional, Tuple

import torch
from torch import nn

from ... import instrument
from ...device import DeviceLike, resolve_device
from ...ops.spmm import DualPropagator, dual_spmm_stacked
from ..dropout import dropout
from ..inits import linear, xavier_1414, zeros
from ..normalize import l2_normalize


class DIMPA(nn.Module):
    """Hop-weighted sums of source walks A^h x_s and target walks
    (A^T)^h x_t with learnable scalar hop weights, concatenated."""

    def __init__(self, hop: int, *, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.hop = hop
        self._w_s = nn.Parameter(torch.ones(hop + 1, 1, device=device))
        self._w_t = nn.Parameter(torch.ones(hop + 1, 1, device=device))

    @instrument.layer("nn.dimpa")
    def forward(self, x_s, x_t, P_s, P_t=None):
        """``P_s``/``P_t``: the two walk Propagators, or ``P_s`` one fused
        DualPropagator and ``P_t`` None: each hop then applies
        ``[P_s curr_s | P_t curr_t]`` at once."""
        w_s, w_t = self._w_s, self._w_t
        feat_s, feat_t = w_s[0] * x_s, w_t[0] * x_t
        if isinstance(P_s, DualPropagator):
            f = x_s.shape[-1]
            curr = torch.cat([x_s, x_t], dim=-1)
            for h in range(1, self.hop + 1):
                curr = dual_spmm_stacked(P_s, curr)
                feat_s = feat_s + w_s[h] * curr[:, :f]
                feat_t = feat_t + w_t[h] * curr[:, f:]
            return torch.cat([feat_s, feat_t], dim=1)
        curr_s, curr_t = x_s, x_t
        for h in range(1, self.hop + 1):
            curr_s, curr_t = P_s(curr_s), P_t(curr_t)
            feat_s = feat_s + w_s[h] * curr_s
            feat_t = feat_t + w_t[h] * curr_t
        return torch.cat([feat_s, feat_t], dim=1)


class DIGRAC_node_clustering(nn.Module):
    """DIGRAC (LoG'22): two 2-layer MLPs (source, target) -> DIMPA ->
    linear head.  Returns (normalized embedding, log-prob, argmax clusters,
    prob).

    ``generator`` draws the initial weights; the forward's ``generator``
    draws the dropout mask when ``training``."""

    def __init__(self, num_features: int, hidden: int, nclass: int,
                 fill_value: float = 0.5, dropout: float = 0.5, hop: int = 2,
                 *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.fill_value, self.dropout = fill_value, dropout
        for name in ("w_s", "w_t"):
            setattr(self, f"{name}0", linear(num_features, hidden, False,
                                             device, generator, xavier_1414))
            setattr(self, f"{name}1", linear(hidden, hidden, False, device,
                                             generator, xavier_1414))
        self.dimpa = DIMPA(hop, device=device)
        self.W_prob = nn.Parameter(
            xavier_1414((2 * hidden, nclass), generator).to(device))
        self.bias = nn.Parameter(zeros((nclass,)).to(device))

    @instrument.layer("nn.digrac_mlp")
    def _mlp(self, x, first, second, training, generator):
        x = torch.relu(first(x))
        return second(dropout(x, self.dropout, training, generator))

    @instrument.layer("nn.digrac")
    def forward(self, P_s, P_t, features, training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, ...]:
        x_s = self._mlp(features, self.w_s0, self.w_s1, training, generator)
        x_t = self._mlp(features, self.w_t0, self.w_t1, training, generator)
        return self._head(self.dimpa(x_s, x_t, P_s, P_t))

    @instrument.layer("nn.digrac_head")
    def _head(self, z):
        output = z @ self.W_prob + self.bias
        return (l2_normalize(z), torch.log_softmax(output, dim=1),
                output.argmax(dim=1), torch.softmax(output, dim=1))
