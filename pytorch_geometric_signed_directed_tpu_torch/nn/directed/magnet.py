"""MagNet node-classification / link-prediction models.

Counterpart of ``pytorch_geometric_signed_directed_tpu/nn/directed/
magnet.py``.  The original 1x1 Conv1d head is a Linear over
concat(real, imag).
"""
from typing import Optional, Tuple, Union

import torch
from torch import nn

from ... import instrument
from ...device import DeviceLike, resolve_device
from ...ops.spmm import Propagator
from ...spectral.magnetic import MagneticTemplate
from ..dropout import dropout
from ..inits import linear
from .magnet_conv import MagNetConv

# what the models' forward takes as ``lap``: an operator pair (a
# MagneticPair unpacks as one) or a trainable-q template
Lap = Union[Tuple[Propagator, Propagator], MagneticTemplate]


class _MagNetTrunk(nn.Module):
    """The conv stack and the Linear head of MagNet (and, with ``conv`` =
    MSConv and its ``conv_kw``, of MSGNN)."""

    def __init__(self, num_features, hidden, q, K, label_dim, activation,
                 trainable_q, layer, dropout, normalization, head_in,
                 device, generator, conv=MagNetConv, **conv_kw):
        super().__init__()
        device = resolve_device(device)
        self.activation, self.dropout = activation, dropout
        self.convs = nn.ModuleList([
            conv(num_features if i == 0 else hidden, hidden, K, q=q,
                 trainable_q=trainable_q, normalization=normalization,
                 device=device, generator=generator, **conv_kw)
            for i in range(layer)])
        self.linear = linear(head_in, label_dim, True, device, generator)

    def _trunk(self, real, imag, lap):
        """The convs, each followed by the complex ReLU with
        ``activation``: the head's input ``[real | imag]`` [N, 2 hidden].
        The state stays lane-stacked from the features on, each layer one
        ``MagNetConv._stacked`` (the ReLU inside it)."""
        z = torch.cat([real, imag], dim=-1)
        for conv in self.convs:
            z = conv._stacked(z, lap, self.activation)
        return z

    @staticmethod
    def _edge_features(z, query_edges):
        """``[real_s, real_t, imag_s, imag_t]`` at ``query_edges`` [Q, 2],
        gathered from the halves of the lane-stacked ``z``."""
        h = z.shape[1] // 2
        s, t = query_edges[:, 0], query_edges[:, 1]
        return torch.cat([z[s, :h], z[t, :h], z[s, h:], z[t, h:]], dim=-1)

    def _drop(self, x, training, generator):
        return dropout(x, self.dropout, training, generator)

    @instrument.layer("nn.magnet_head")
    def _head(self, x, training, generator):
        return torch.log_softmax(
            self.linear(self._drop(x, training, generator)), dim=1)


class MagNet_node_classification(_MagNetTrunk):
    """MagNet node classification (NeurIPS'21): MagNetConv stack +
    complex ReLU, concat(real, imag) -> Linear head -> log_softmax.

    ``generator`` draws the initial weights; the forward's ``generator``
    draws the dropout mask when ``training``."""

    def __init__(self, num_features: int, hidden: int = 2, q: float = 0.25,
                 K: int = 1, label_dim: int = 2, activation: bool = False,
                 trainable_q: bool = False, layer: int = 2,
                 dropout: float = 0.0, normalization: Optional[str] = "sym",
                 *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_features, hidden, q, K, label_dim, activation,
                         trainable_q, layer, dropout, normalization,
                         2 * hidden, device, generator)

    @instrument.layer("nn.magnet_node")
    def forward(self, real, imag, lap, training: bool = False,
                generator: Optional[torch.Generator] = None):
        return self._head(self._trunk(real, imag, lap), training, generator)


class MagNet_link_prediction(_MagNetTrunk):
    """MagNet link prediction: the same trunk; gathers [real_s, real_t,
    imag_s, imag_t] at ``query_edges`` [Q, 2] -> Linear -> log_softmax."""

    def __init__(self, num_features: int, hidden: int = 2, q: float = 0.25,
                 K: int = 1, label_dim: int = 2, activation: bool = False,
                 trainable_q: bool = False, layer: int = 2,
                 dropout: float = 0.0, normalization: Optional[str] = "sym",
                 *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_features, hidden, q, K, label_dim, activation,
                         trainable_q, layer, dropout, normalization,
                         4 * hidden, device, generator)

    def forward(self, real, imag, lap, query_edges, training: bool = False,
                generator: Optional[torch.Generator] = None):
        return self._head(
            self._edge_features(self._trunk(real, imag, lap), query_edges),
            training, generator)
