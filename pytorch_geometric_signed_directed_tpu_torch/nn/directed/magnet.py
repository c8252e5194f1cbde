"""MagNet node-classification / link-prediction models.

Counterpart of ``pytorch_geometric_signed_directed_tpu/nn/directed/
magnet.py``.  The original 1x1 Conv1d head is a Linear over
concat(real, imag).
"""
from typing import Optional

import torch
from torch import nn

from ...device import DeviceLike, resolve_device
from ..inits import lecun_normal, zeros
from .complex_relu import complex_relu
from .magnet_conv import MagNetConv


def _dropout(x: torch.Tensor, p: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class _MagNetTrunk(nn.Module):
    def __init__(self, num_features, hidden, q, K, label_dim, activation,
                 trainable_q, layer, dropout, normalization, head_in,
                 device, generator):
        super().__init__()
        device = resolve_device(device)
        self.activation, self.dropout = activation, dropout
        self.convs = nn.ModuleList([
            MagNetConv(num_features if i == 0 else hidden, hidden, K, q=q,
                       trainable_q=trainable_q, normalization=normalization,
                       device=device, generator=generator)
            for i in range(layer)])
        # built on "meta" so its default init draws nothing from the
        # global RNG; the weights come from ``generator``
        self.linear = nn.Linear(head_in, label_dim, device="meta")
        self.linear.weight = nn.Parameter(
            lecun_normal((label_dim, head_in), generator).to(device))
        self.linear.bias = nn.Parameter(zeros((label_dim,)).to(device))

    def _trunk(self, real, imag, lap):
        for conv in self.convs:
            real, imag = conv(real, imag, lap)
            if self.activation:
                real, imag = complex_relu(real, imag)
        return real, imag

    def _head(self, x, training, generator):
        if training and self.dropout > 0:
            x = _dropout(x, self.dropout, generator)
        return torch.log_softmax(self.linear(x), dim=1)


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

    def forward(self, real, imag, lap, training: bool = False,
                generator: Optional[torch.Generator] = None):
        real, imag = self._trunk(real, imag, lap)
        return self._head(torch.cat([real, imag], dim=-1), training,
                          generator)


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
        real, imag = self._trunk(real, imag, lap)
        s, t = query_edges[:, 0], query_edges[:, 1]
        x = torch.cat([real[s], real[t], imag[s], imag[t]], dim=-1)
        return self._head(x, training, generator)
