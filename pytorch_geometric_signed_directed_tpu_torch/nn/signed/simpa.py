"""SIMPA: signed mixed-path aggregation.

Counterpart of ``pytorch_geometric_signed_directed_tpu/nn/signed/
simpa.py``.  The walk operators (``graph.rw_norm_propagator`` with a
self-loop fill for the positive graph and none for the negative one)
arrive as Propagators.
"""
from typing import Optional

import torch
from torch import nn

from ...device import DeviceLike, resolve_device
from ...ops.spmm import Propagator


class SIMPA(nn.Module):
    """Hop-weighted positive walks P_p^h x_p, plus the hop(hop+1)/2 "enemy"
    paths P_p^a P_n P_p^b x_n (a + b < hop), each with a learnable scalar
    weight; ``directed`` runs a source and a target stream and
    concatenates four blocks of features instead of two."""

    def __init__(self, hop: int, directed: bool = False, *,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.hop, self.directed = hop, directed
        hop_p, hop_n = hop + 1, (hop + 1) * hop // 2
        names = (("_w_p", "_w_n") if not directed else
                 ("_w_sp", "_w_sn", "_w_tp", "_w_tn"))
        for name in names:
            size = hop_p if name.endswith("p") else hop_n
            setattr(self, name,
                    nn.Parameter(torch.ones(size, 1, device=device)))

    def _aggregate(self, x_p, x_n, P_p: Propagator, P_n: Propagator,
                   w_p, w_n):
        """The JAX package's order of terms.  Its last positive walk of
        x_n (which feeds no enemy path) is left out: XLA drops it too."""
        hop_p = self.hop + 1
        feat_p = w_p[0] * x_p
        feat_n = torch.zeros_like(feat_p)
        curr_p, curr_n_aux = x_p, x_n
        j = 0
        for h in range(hop_p):
            if h > 0:
                curr_p = P_p(curr_p)
                feat_p = feat_p + w_p[h] * curr_p
                if h != hop_p - 1:
                    curr_n_aux = P_p(curr_n_aux)
            if h != hop_p - 1:
                curr_n = P_n(curr_n_aux)
                feat_n = feat_n + w_n[j] * curr_n
                j += 1
                for _ in range(hop_p - 2 - h):
                    curr_n = P_p(curr_n)
                    feat_n = feat_n + w_n[j] * curr_n
                    j += 1
        return feat_p, feat_n

    def forward(self, P_p: Propagator, P_n: Propagator, x_p, x_n,
                P_pt: Optional[Propagator] = None,
                P_nt: Optional[Propagator] = None,
                x_pt=None, x_nt=None) -> torch.Tensor:
        if not self.directed:
            return torch.cat(self._aggregate(x_p, x_n, P_p, P_n, self._w_p,
                                             self._w_n), dim=1)
        s = self._aggregate(x_p, x_n, P_p, P_n, self._w_sp, self._w_sn)
        t = self._aggregate(x_pt, x_nt, P_pt, P_nt, self._w_tp, self._w_tn)
        return torch.cat([*s, *t], dim=1)
