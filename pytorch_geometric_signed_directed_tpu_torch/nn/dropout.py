"""Dropout drawn from an explicit generator, switched by an explicit
``training`` flag (as the JAX models' ``training`` argument), never by
``Module.train()``."""
from typing import Optional

import torch

from ..instrument import layer


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    if not training or not p:
        return x
    return _drop(x, p, generator)


@layer("nn.dropout")
def _drop(x: torch.Tensor, p: float,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
