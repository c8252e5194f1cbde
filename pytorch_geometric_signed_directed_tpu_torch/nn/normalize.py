"""Gradient-safe L2 normalization.

Counterpart of ``pytorch_geometric_signed_directed_tpu/nn/normalize.py``:
the ``rsqrt(sumsq + eps)`` form, smooth everywhere.  ``F.normalize``
clamps the norm instead and has another gradient at a zero row.
"""
import torch


def l2_normalize(x: torch.Tensor, axis: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(dim=axis, keepdim=True) + eps)
