"""Optimizer factories for ``scan_node_training``.

The JAX trainer takes an optax ``GradientTransformation``; every JAX caller
of ``scan_node_training`` passes ``optax.chain(add_decayed_weights(wd),
adam(lr))`` (``scripts/reference_protocol_magnet.py``).  Here the
transformation is a factory that makes the optimizer over a model's
parameters.
"""
from typing import Callable, Iterable

import torch

from ..instrument import span

OptimizerFactory = Callable[[Iterable[torch.nn.Parameter]],
                            torch.optim.Optimizer]


def adam(lr: float, weight_decay: float = 0.0,
         decoupled: bool = False) -> OptimizerFactory:
    """Adam with coupled L2 (``torch.optim.Adam(weight_decay=...)``: the
    decay joins the gradient before the moments, optax's
    ``add_decayed_weights`` then ``adam``), or AdamW's decoupled decay with
    ``decoupled`` (optax's ``adamw``), as ``Trainer`` takes them.  On CUDA
    parameters the optimizer is ``capturable``: its step count and bias
    corrections live on the device, so a CUDA graph can replay its step.
    The construction is the span ``pgsd.train.optimizer_build``."""

    def make(params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        with span("train.optimizer_build"):
            params = list(params)
            opt = torch.optim.AdamW if decoupled else torch.optim.Adam
            return opt(params, lr=lr, weight_decay=weight_decay,
                       capturable=any(p.is_cuda for p in params))

    return make
