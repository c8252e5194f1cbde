"""DiGCL: directed graph contrastive learning.

Counterpart of ``pytorch_geometric_signed_directed_tpu/nn/directed/
digcl.py``.  The two graph views (``spectral.cal_fast_appr`` at two
alphas) arrive as GCN-normalized Propagators
(``graph.gcn_norm_propagator``), so each convolution is a Linear, the
operator's apply and a bias; above 8,192 nodes ``mode="auto"`` applies
them by K1 on the kernel tier.  The contrastive loss is stock PyTorch:
its [B, N] similarity blocks are ``torch.matmul``s, as the JAX package
computes them outside any Pallas kernel.
"""
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...device import DeviceLike, resolve_device
from ...ops.spmm import Propagator
from ..inits import glorot, linear, zeros
from ..normalize import l2_normalize

# torch's RReLU samples the negative slope in [1/8, 1/3] while training
# and takes the mean in eval; DiGCL takes the mean throughout, as the JAX
# package does, so a step is deterministic
_RRELU_SLOPE = (1.0 / 8 + 1.0 / 3) / 2


class _GCNConv(nn.Module):
    """PyG's GCNConv body: a Linear without bias (Glorot), the operator's
    apply (which holds the gcn normalization), then the bias (zeros)."""

    def __init__(self, in_channels: int, out_channels: int, *,
                 device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.linear = linear(in_channels, out_channels, False, device,
                             generator, init=glorot)
        self.bias = nn.Parameter(zeros((out_channels,)).to(device))

    def forward(self, x: torch.Tensor, P: Propagator) -> torch.Tensor:
        return P(self.linear(x)) + self.bias


def _torch_linear(in_features: int, out_features: int,
                  device: torch.device,
                  generator: Optional[torch.Generator]) -> nn.Linear:
    """``torch.nn.Linear``'s init: weight and bias both
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn from ``generator``."""
    bound = 1.0 / math.sqrt(in_features)
    layer = nn.Linear(in_features, out_features, device="meta")
    layer.weight = nn.Parameter(torch.empty(out_features, in_features)
                                .uniform_(-bound, bound, generator=generator)
                                .to(device))
    layer.bias = nn.Parameter(torch.empty(out_features)
                              .uniform_(-bound, bound, generator=generator)
                              .to(device))
    return layer


class _PReLU(nn.Module):
    """``torch.nn.PReLU``: one trainable slope, 0.25 at first."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.slope = nn.Parameter(torch.full((1,), 0.25, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.slope * x)


def _rrelu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, _RRELU_SLOPE * x)


class DiGCL_Encoder(nn.Module):
    """``num_layers`` GCN convolutions over a graph view: widths
    2 out_channels, ..., out_channels, each followed by the activation
    (``"relu"``, ``"prelu"`` with one slope shared by the layers, or
    ``"rrelu"`` at its mean slope)."""

    def __init__(self, in_channels: int, out_channels: int,
                 activation: str = "relu", num_layers: int = 2, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if num_layers < 2:
            raise ValueError("DiGCL_Encoder needs at least 2 layers")
        device = resolve_device(device)
        widths = [in_channels] + [2 * out_channels] * (num_layers - 1) \
            + [out_channels]
        self.convs = nn.ModuleList(
            _GCNConv(a, b, device=device, generator=generator)
            for a, b in zip(widths[:-1], widths[1:]))
        self.activation = activation
        if activation == "prelu":
            self.prelu = _PReLU(device)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        if self.activation == "prelu":
            return self.prelu(x)
        if self.activation == "rrelu":
            return _rrelu(x)
        return torch.relu(x)

    def forward(self, x: torch.Tensor, P: Propagator) -> torch.Tensor:
        for conv in self.convs:
            x = self.act(conv(x, P))
        return x


class DiGCL(nn.Module):
    """Directed graph contrastive learning (NeurIPS'21): the encoder, a
    projection MLP (``fc1``, ELU, ``fc2`` with ``torch.nn.Linear``'s
    init) and the InfoNCE loss between two views' embeddings, whole or
    in row batches."""

    def __init__(self, in_channels: int, activation: str, num_hidden: int,
                 num_proj_hidden: int, tau: float, num_layers: int, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.tau = tau
        self.encoder = DiGCL_Encoder(in_channels, num_hidden, activation,
                                     num_layers, device=device,
                                     generator=generator)
        self.fc1 = _torch_linear(num_hidden, num_proj_hidden, device,
                                 generator)
        self.fc2 = _torch_linear(num_proj_hidden, num_hidden, device,
                                 generator)

    def forward(self, x: torch.Tensor, P: Propagator) -> torch.Tensor:
        return self.encoder(x, P)

    def projection(self, z: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.elu(self.fc1(z)))

    @staticmethod
    def sim(z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
        return l2_normalize(z1) @ l2_normalize(z2).T

    def _f(self, s: torch.Tensor) -> torch.Tensor:
        return torch.exp(s / self.tau)

    def semi_loss(self, z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
        refl = self._f(self.sim(z1, z1))
        between = self._f(self.sim(z1, z2))
        return -torch.log(between.diagonal() / (
            refl.sum(1) + between.diagonal() - refl.diagonal()))

    def batched_semi_loss(self, z1: torch.Tensor, z2: torch.Tensor,
                          batch_size: int) -> torch.Tensor:
        """The per-row loss of z1 against z2 in blocks of ``batch_size``
        rows, each block's [B, N] similarities recomputed in the backward
        (``torch.utils.checkpoint``), so memory is O(B N).  The last block
        is padded with row N-1 and the padded rows' losses are 0.  The
        denominator is refl.sum + between.sum - diag(refl), as in the JAX
        package (``semi_loss`` adds diag(between) instead)."""
        n = z1.shape[0]
        num_batches = (n - 1) // batch_size + 1
        idx = torch.arange(num_batches * batch_size, device=z1.device)
        valid = idx < n
        idx = idx.clamp(max=n - 1).view(num_batches, batch_size)
        rows = torch.arange(batch_size, device=z1.device)
        h1, h2 = l2_normalize(z1), l2_normalize(z2)

        def body(mask_idx, h1, h2):
            hb = h1[mask_idx]
            refl = self._f(hb @ h1.T)
            between = self._f(hb @ h2.T)
            diag_between = between[rows, mask_idx]
            diag_refl = refl[rows, mask_idx]
            return -torch.log(diag_between / (
                refl.sum(1) + between.sum(1) - diag_refl))

        losses = torch.cat([checkpoint(body, idx[b], h1, h2,
                                       use_reentrant=False)
                            for b in range(num_batches)])
        return torch.where(valid, losses, torch.zeros_like(losses))

    def loss(self, z1: torch.Tensor, z2: torch.Tensor, mean: bool = True,
             batch_size: int = 0) -> torch.Tensor:
        h1 = self.projection(z1)
        h2 = self.projection(z2)
        if batch_size == 0:
            l1 = self.semi_loss(h1, h2)
            l2 = self.semi_loss(h2, h1)
        else:
            l1 = self.batched_semi_loss(h1, h2, batch_size)
            l2 = self.batched_semi_loss(h2, h1, batch_size)
        total = ((l1 + l2) * 0.5).sum()
        return total / z1.shape[0] if mean else total
