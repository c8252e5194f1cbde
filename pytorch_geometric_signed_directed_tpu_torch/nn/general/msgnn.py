"""MSGNN: link-prediction and node-classification heads over MSConv.

Counterpart of ``pytorch_geometric_signed_directed_tpu/nn/general/
msgnn.py``.  The trunk and head are MagNet's (``_MagNetTrunk``) with
MSConv layers; dropout acts on the head's input when ``training``, drawn
from the forward's ``generator``.
"""
from typing import Optional

import torch

from ...device import DeviceLike
from ..directed.magnet import Lap, _MagNetTrunk  # noqa: F401
from ..normalize import l2_normalize
from .msconv import MSConv


class _MSGNN(_MagNetTrunk):
    def __init__(self, num_features, hidden, q, K, label_dim, activation,
                 trainable_q, layer, dropout, normalization, conv_bias,
                 absolute_degree, head_in, device, generator):
        super().__init__(num_features, hidden, q, K, label_dim, activation,
                         trainable_q, layer, dropout, normalization, head_in,
                         device, generator, conv=MSConv, bias=conv_bias,
                         absolute_degree=absolute_degree)


class MSGNN_link_prediction(_MSGNN):
    """MSGNN link prediction (LoG'22): the MSConv trunk over the signed
    magnetic Laplacian; gathers [real_s, real_t, imag_s, imag_t] at
    ``query_edges`` [Q, 2] -> Linear -> log_softmax.  Returns
    ``(log_prob, z)`` with ``z`` the head's input."""

    def __init__(self, num_features: int, hidden: int = 2, q: float = 0.25,
                 K: int = 2, label_dim: int = 2, activation: bool = True,
                 trainable_q: bool = False, layer: int = 2,
                 dropout: float = 0.5, normalization: Optional[str] = "sym",
                 conv_bias: bool = True, absolute_degree: bool = True, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_features, hidden, q, K, label_dim, activation,
                         trainable_q, layer, dropout, normalization,
                         conv_bias, absolute_degree, 4 * hidden, device,
                         generator)

    def forward(self, real, imag, lap, query_edges, training: bool = False,
                generator: Optional[torch.Generator] = None):
        z = self._drop(
            self._edge_features(self._trunk(real, imag, lap), query_edges),
            training, generator)
        return torch.log_softmax(self.linear(z), dim=1), z


class MSGNN_node_classification(_MSGNN):
    """MSGNN node classification: the MSConv trunk, concat(real, imag) ->
    Linear.  Returns ``(z_norm, log_prob, argmax, softmax)`` with
    ``z_norm`` the L2-normalized head input."""

    def __init__(self, num_features: int, hidden: int = 2, q: float = 0.25,
                 K: int = 2, label_dim: int = 2, activation: bool = True,
                 trainable_q: bool = False, layer: int = 2,
                 dropout: float = 0.5, normalization: Optional[str] = "sym",
                 conv_bias: bool = True, absolute_degree: bool = True, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_features, hidden, q, K, label_dim, activation,
                         trainable_q, layer, dropout, normalization,
                         conv_bias, absolute_degree, 2 * hidden, device,
                         generator)

    def forward(self, real, imag, lap, training: bool = False,
                generator: Optional[torch.Generator] = None):
        z = self._drop(self._trunk(real, imag, lap), training, generator)
        x = self.linear(z)
        log_prob = torch.log_softmax(x, dim=1)
        return (l2_normalize(z), log_prob, torch.argmax(log_prob, dim=1),
                torch.softmax(x, dim=1))
