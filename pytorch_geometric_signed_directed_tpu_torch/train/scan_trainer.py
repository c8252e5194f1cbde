"""Masked node-classification loss.

Counterpart of ``masked_nll`` in ``pytorch_geometric_signed_directed_tpu/
train/scan_trainer.py``.  That module's ``scan_node_training`` (the whole
training as one program, a ``lax.scan`` over epochs) waits for a captured
CUDA-graph step on the card (ROADMAP.md, step items).
"""
import torch


def masked_nll(logp: torch.Tensor, y: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over ``mask`` (float [N])."""
    per_node = -logp[torch.arange(logp.shape[0], device=logp.device),
                     y] * mask
    return per_node.sum() / torch.clamp_min(mask.sum(), 1.0)
