"""Segment reductions through ``index_add_`` and ``scatter_reduce`` — the
segment tier.

Counterpart of ``pytorch_geometric_signed_directed_tpu/ops/segment.py``.
It is a tier of its own, chosen by ``mode="segment"`` (and by the
attention layers' ``aggregate="segment"``), not a stand-in for the CSR
kernel.  As in JAX, ids outside ``[0, num_segments)`` (the padding
convention) are dropped: they land in one extra segment that is cut off.
On CUDA ``index_add_`` adds with atomics, so the order of the sum changes
from run to run.
"""
import torch


def _with_spare(segment_ids: torch.Tensor, num_segments: int):
    """The ids with every one outside ``[0, num_segments)`` sent to the
    spare segment ``num_segments``."""
    ok = (segment_ids >= 0) & (segment_ids < num_segments)
    return torch.where(ok, segment_ids, num_segments)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                indices_are_sorted: bool = False) -> torch.Tensor:
    """out[s] = sum of data[e] over the e with segment_ids[e] == s.

    ``indices_are_sorted`` is accepted for the JAX signature and not
    read: the ids may come in any order."""
    out = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    out = out.index_add(0, _with_spare(segment_ids, num_segments), data)
    return out[:num_segments]


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int,
                 indices_are_sorted: bool = False) -> torch.Tensor:
    """The sum of each segment over its count, an empty segment's count
    taken as 1 (its mean is 0).

    ``indices_are_sorted`` is accepted for the JAX signature and not
    read: the ids may come in any order."""
    s = segment_sum(data, segment_ids, num_segments)
    ones = torch.ones(data.shape[:1], dtype=data.dtype, device=data.device)
    cnt = segment_sum(ones, segment_ids, num_segments).clamp_min(1.0)
    return s / cnt.reshape((-1,) + (1,) * (data.dim() - 1))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                indices_are_sorted: bool = False) -> torch.Tensor:
    """out[s] = max of data[e] over the e with segment_ids[e] == s; an
    empty segment holds -inf (``jax.ops.segment_max``'s identity).

    ``indices_are_sorted`` is accepted for the JAX signature and not
    read: the ids may come in any order."""
    ids = _with_spare(segment_ids, num_segments).long()
    out = torch.full((num_segments + 1,) + tuple(data.shape[1:]),
                     float("-inf"), dtype=data.dtype, device=data.device)
    index = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out = out.scatter_reduce(0, index, data, "amax", include_self=True)
    return out[:num_segments]


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    indices_are_sorted: bool = False) -> torch.Tensor:
    """Softmax of 1-D ``logits`` over the edges of each segment, shifted
    by the segment's max (0 where that max is not finite), the denominator
    floored at ``finfo.tiny``; padding ids get weight 0.

    ``indices_are_sorted`` is accepted for the JAX signature and not
    read: the ids may come in any order."""
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    neg_inf = torch.finfo(logits.dtype).min
    maxes = segment_max(torch.where(valid, logits, neg_inf), segment_ids,
                        num_segments)
    maxes = torch.where(torch.isfinite(maxes), maxes, 0.0)
    safe = segment_ids.clamp(0, num_segments - 1)
    gathered_max = torch.where(valid, maxes[safe], 0.0)
    ex = torch.where(valid, torch.exp(logits - gathered_max), 0.0)
    denom = segment_sum(ex, segment_ids, num_segments)
    denom = denom.clamp_min(torch.finfo(logits.dtype).tiny)
    return ex / torch.where(valid, denom[safe], 1.0)
