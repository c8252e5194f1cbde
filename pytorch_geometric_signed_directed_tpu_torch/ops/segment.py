"""Segment sum through ``index_add_`` — the segment tier.

Counterpart of ``pytorch_geometric_signed_directed_tpu/ops/segment.py``
(``segment_sum``).  It is a tier of its own, chosen by ``mode="segment"``,
not a stand-in for the CSR kernel.  On CUDA ``index_add_`` adds with
atomics, so the order of the sum changes from run to run.
"""
import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """out[s] = sum of data[e] over the e with segment_ids[e] == s."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids, data)
