"""SGCNConv: the balance-theory signed convolution.

Counterpart of ``pytorch_geometric_signed_directed_tpu/nn/signed/
sgcn_conv.py``.  The mean aggregations over the positive and the negative
edges arrive as two mean Propagators (``graph.mean_propagator``), or fused
into one union-edge-set DualPropagator (``sgcn.sgcn_dual_propagator``)
that applies both in one pass.  Linears take flax's ``nn.Dense`` defaults
from ``generator``.
"""
from typing import Optional

import torch
from torch import nn

from ...device import DeviceLike, resolve_device
from ...ops.spmm import DualPropagator, dual_spmm_stacked
from ..inits import linear
from ..normalize import l2_normalize


class SGCNConv(nn.Module):
    """``first_aggr``: balanced and unbalanced channels from the positive
    and the negative mean of x; otherwise each channel mixes the positive
    mean of itself with the negative mean of the other.  Returns
    [balanced | unbalanced], each ``out_dim`` wide."""

    def __init__(self, in_dim: int, out_dim: int, first_aggr: bool,
                 use_bias: bool = True, norm_emb: bool = False, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.in_dim, self.first_aggr, self.norm_emb = (in_dim, first_aggr,
                                                        norm_emb)
        width = (2 if first_aggr else 3) * in_dim
        self.lin_b = linear(width, out_dim, use_bias, device, generator)
        self.lin_u = linear(width, out_dim, use_bias, device, generator)

    def forward(self, x: torch.Tensor, P_pos, P_neg=None) -> torch.Tensor:
        """``P_pos``/``P_neg``: the two mean Propagators, or ``P_pos`` the
        fused DualPropagator and ``P_neg`` None: a layer then makes half the
        applies ([P_pos x_a | P_neg x_b] at once)."""
        dual = P_pos if isinstance(P_pos, DualPropagator) else None
        if self.first_aggr:
            if dual is not None:
                f = x.shape[-1]
                y = dual_spmm_stacked(dual, torch.cat([x, x], dim=-1))
                px, nx = y[..., :f], y[..., f:]
            else:
                px, nx = P_pos(x), P_neg(x)
            out_b = self.lin_b(torch.cat([px, x], dim=-1))
            out_u = self.lin_u(torch.cat([nx, x], dim=-1))
        else:
            f = self.in_dim
            x_b, x_u = x[..., :f], x[..., f:]
            if dual is not None:
                y1 = dual_spmm_stacked(dual, torch.cat([x_b, x_u], dim=-1))
                y2 = dual_spmm_stacked(dual, torch.cat([x_u, x_b], dim=-1))
                p_b, n_u = y1[..., :f], y1[..., f:]
                p_u, n_b = y2[..., :f], y2[..., f:]
            else:
                p_b, n_u = P_pos(x_b), P_neg(x_u)
                p_u, n_b = P_pos(x_u), P_neg(x_b)
            out_b = self.lin_b(torch.cat([p_b, n_u, x_b], dim=-1))
            out_u = self.lin_u(torch.cat([p_u, n_b, x_u], dim=-1))
        out = torch.cat([out_b, out_u], dim=-1)
        return l2_normalize(out) if self.norm_emb else out
