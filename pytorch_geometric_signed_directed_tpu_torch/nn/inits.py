"""Weight initializers (drawn on the CPU from an explicit generator, so a
seed gives the same weights whatever the target device)."""
import math
from typing import Optional, Sequence

import torch


def glorot(shape: Sequence[int],
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Uniform(-a, a) with a = sqrt(6 / (fan_in + fan_out)) over the last
    two dims — PyG's ``glorot`` used by the MagNetConv weights."""
    fan_in, fan_out = shape[-2], shape[-1]
    a = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(tuple(shape)).uniform_(-a, a, generator=generator)


def zeros(shape: Sequence[int]) -> torch.Tensor:
    return torch.zeros(tuple(shape))


def lecun_normal(shape: Sequence[int],
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Normal(0, 1/fan_in) for a [fan_out, fan_in] linear weight (a plain,
    untruncated form of flax's Dense default)."""
    std = 1.0 / math.sqrt(shape[-1])
    return torch.empty(tuple(shape)).normal_(0.0, std, generator=generator)
