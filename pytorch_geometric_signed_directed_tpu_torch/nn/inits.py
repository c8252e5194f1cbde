"""Weight initializers (drawn on the CPU from an explicit generator, so a
seed gives the same weights whatever the target device)."""
import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn


def glorot(shape: Sequence[int],
           generator: Optional[torch.Generator] = None,
           gain_sq: float = 1.0) -> torch.Tensor:
    """Uniform(-a, a) with a = sqrt(6 gain_sq / (fan_in + fan_out)) over the
    last two dims — PyG's ``glorot`` used by the MagNetConv weights; with
    ``gain_sq=2`` DIGRAC's xavier-uniform of gain 1.414 (flax's
    ``variance_scaling(2.0, "fan_avg", "uniform")``)."""
    fan_in, fan_out = shape[-2], shape[-1]
    a = math.sqrt(6.0 * gain_sq / (fan_in + fan_out))
    return torch.empty(tuple(shape)).uniform_(-a, a, generator=generator)


def xavier_1414(shape: Sequence[int],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """xavier-uniform with gain 1.414 (gain^2 = 2): the weights of DIGRAC
    and SSSNET."""
    return glorot(shape, generator, gain_sq=2.0)


def zeros(shape: Sequence[int]) -> torch.Tensor:
    return torch.zeros(tuple(shape))


def lecun_normal(shape: Sequence[int],
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Normal(0, 1/fan_in) for a [fan_out, fan_in] linear weight (a plain,
    untruncated form of flax's Dense default)."""
    std = 1.0 / math.sqrt(shape[-1])
    return torch.empty(tuple(shape)).normal_(0.0, std, generator=generator)


def linear(in_features: int, out_features: int, bias: bool,
           device: torch.device, generator: Optional[torch.Generator],
           init: Callable = lecun_normal) -> nn.Linear:
    """A Linear whose weight [out, in] comes from ``init(shape,
    generator)`` and whose bias is 0 — flax's ``nn.Dense`` defaults.  Built
    on "meta" first, so its own default init draws nothing from the global
    RNG."""
    layer = nn.Linear(in_features, out_features, bias=bias, device="meta")
    layer.weight = nn.Parameter(
        init((out_features, in_features), generator).to(device))
    if bias:
        layer.bias = nn.Parameter(zeros((out_features,)).to(device))
    return layer
