"""MagNetConv: Chebyshev filter over the scaled magnetic Laplacian.

Counterpart of ``pytorch_geometric_signed_directed_tpu/nn/directed/
magnet_conv.py`` for frozen q.  The original layer runs four propagate
streams, two of which repeat the other two, so the math is two Chebyshev
recurrences:

    S1_k = T_k(L_re) x_re      S2_k = T_k(L_im) x_im
    out_re = sum_k (S1_k - S2_k) W_k + b
    out_im = sum_k (S1_k + S2_k) W_k + b

On the sparse tiers both recurrences run in lockstep through the fused
operator pair, one lane-stacked apply per order.  The K+1 weight applies
are one float32 einsum.
"""
from typing import Optional, Tuple

import torch
from torch import nn

from ...device import DeviceLike, resolve_device
from ...ops.spmm import DualPropagator, Propagator, dual_spmm_stacked
from ...spectral.magnetic import MagneticPair
from ..inits import glorot, zeros


def chebyshev_stack(P: Propagator, x: torch.Tensor, K: int) -> torch.Tensor:
    """[K+1, N, F] stack of Chebyshev polynomials T_k(P) x."""
    ts = [x]
    if K >= 1:
        ts.append(P(x))
    for _ in range(2, K + 1):
        ts.append(2.0 * P(ts[-1]) - ts[-2])
    return torch.stack(ts)


def dual_chebyshev_stacks(D: DualPropagator, x_a: torch.Tensor,
                          x_b: torch.Tensor, K: int,
                          apply=dual_spmm_stacked):
    """Both Chebyshev stacks through the fused pair.  The recurrence state
    stays lane-stacked [N, 2F] throughout; the split back into the two
    streams happens once at the end."""
    f = x_a.shape[1]
    ts = [torch.cat([x_a, x_b], dim=1)]
    if K >= 1:
        ts.append(apply(D, ts[0]))
    for _ in range(2, K + 1):
        ts.append(2.0 * apply(D, ts[-1]) - ts[-2])
    s = torch.stack(ts)                      # [K+1, N, 2F]
    return s[:, :, :f], s[:, :, f:]


class MagNetConv(nn.Module):
    """Args mirror the original layer; the forward takes ``lap``, a
    MagneticPair (or a (P_re, P_im) tuple) from ``magnet_propagators``.

    ``generator`` draws the initial weights (on the CPU); ``device``
    places them (None means "cuda")."""

    def __init__(self, in_channels: int, out_channels: int, K: int,
                 q: float = 0.25, trainable_q: bool = False,
                 normalization: Optional[str] = "sym", bias: bool = True,
                 *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if K <= 0:
            raise ValueError(f"K must be positive, got {K}")
        if trainable_q:
            raise NotImplementedError(
                "trainable q is not ported yet (ROADMAP.md queue A, "
                "'Trainable q')")
        device = resolve_device(device)
        self.in_channels, self.out_channels, self.K = (in_channels,
                                                       out_channels, K)
        self.q, self.normalization = q, normalization
        self.weight = nn.Parameter(
            glorot((K + 1, in_channels, out_channels), generator).to(device))
        if bias:
            self.bias = nn.Parameter(zeros((out_channels,)).to(device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x_real: torch.Tensor, x_imag: torch.Tensor,
                lap) -> Tuple[torch.Tensor, torch.Tensor]:
        P_re, P_im = lap
        dual = lap.dual if isinstance(lap, MagneticPair) else None
        if dual is not None:
            s1, s2 = dual_chebyshev_stacks(dual, x_real, x_imag, self.K)
        else:
            s1 = chebyshev_stack(P_re, x_real, self.K)  # [K+1, N, F]
            s2 = chebyshev_stack(P_im, x_imag, self.K)
        o1 = torch.einsum("knf,kfo->no", s1, self.weight)
        o2 = torch.einsum("knf,kfo->no", s2, self.weight)
        out_real = o1 - o2
        out_imag = o1 + o2
        if self.bias is not None:
            out_real = out_real + self.bias
            out_imag = out_imag + self.bias
        return out_real, out_imag
