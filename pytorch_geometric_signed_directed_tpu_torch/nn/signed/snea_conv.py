"""SNEAConv: signed attention convolution, and the attention aggregate
that GATConv and the motif models share.

Counterpart of ``pytorch_geometric_signed_directed_tpu/nn/signed/
snea_conv.py``.  An ``AttnGraph`` is a destination-sorted CSR of the
edges, built once; the per-edge attention (a Linear on [x_j | x_i], tanh)
is softmaxed by destination and weights the messages.  Two aggregates:

  * ``"mxu"`` (the default): one global shift, then ONE segment sum of
    the stacked ``[exp | msgs * exp]`` through K1 ``csr_scatter_sum``
    (``ops.scatter.scatter_sum``, differentiable), at width 1 + F; the
    pair form sums two attends of one graph at width 2 + 2F;
  * ``"segment"``: ``ops.segment.segment_softmax`` and ``segment_sum``
    (the JAX package's ``"xla"`` backend, which it selects by a module
    global).

Faithful to the reference's message function: the aggregated message is
alpha * x_i, the *destination* feature selected per edge type, not the
source feature.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...device import DeviceLike, resolve_device
from ...ops.scatter import ScatterPlan, build_scatter_plan, scatter_sum
from ...ops.segment import segment_softmax, segment_sum
from ..inits import linear, xavier_normal

AGGREGATES = ("mxu", "segment")

# The fused pair path gathers a lane-stacked [N, 4F] table; wider layers
# take two separate attends, as in the JAX package.
PAIR_FUSION_MAX_LANES = 128


@dataclass(frozen=True)
class AttnGraph:
    """Edges sorted by destination (stable): ``src``/``dst`` [E] int64,
    ``edge_p`` [E] int32 edge-type selector (0 balanced, 1 unbalanced) and
    the destination CSR ``plan`` over ``num_nodes`` rows (its ``row_ids``
    are ``dst``).  No padding slots: every edge is real."""

    src: torch.Tensor
    dst: torch.Tensor
    edge_p: torch.Tensor
    plan: ScatterPlan
    num_nodes: int

    @property
    def rowptr(self) -> torch.Tensor:
        return self.plan.rowptr

    @property
    def row_ids(self) -> torch.Tensor:
        return self.plan.row_ids

    @property
    def split(self):
        return self.plan.split


def build_attention_graph(edge_sets, num_nodes: int,
                          device: DeviceLike = None) -> AttnGraph:
    """``edge_sets``: list of (edge_index [2, E], flag, add_self_loops).
    Self-edges are dropped from every set; a set with the flag gets one
    loop a node appended.  Duplicate edges are kept (each counts in the
    softmax)."""
    device = resolve_device(device)
    srcs, dsts, flags = [], [], []
    for edge_index, flag, loops in edge_sets:
        edge_index = np.asarray(edge_index).reshape(2, -1)
        edge_index = edge_index[:, edge_index[0] != edge_index[1]]
        s, d = edge_index[0], edge_index[1]
        if loops:
            s = np.concatenate([s, np.arange(num_nodes)])
            d = np.concatenate([d, np.arange(num_nodes)])
        srcs.append(s)
        dsts.append(d)
        flags.append(np.full(len(s), flag))
    src = np.concatenate(srcs).astype(np.int64)
    dst = np.concatenate(dsts).astype(np.int64)
    flag = np.concatenate(flags).astype(np.int32)
    order = np.argsort(dst, kind="stable")
    src, dst, flag = src[order], dst[order], flag[order]
    plan = build_scatter_plan(dst, num_nodes, device=device)
    return AttnGraph(src=torch.from_numpy(src).to(device), dst=plan.row_ids,
                     edge_p=torch.from_numpy(flag).to(device), plan=plan,
                     num_nodes=num_nodes)


def _check_aggregate(aggregate: str) -> None:
    if aggregate not in AGGREGATES:
        raise ValueError(f"aggregate={aggregate!r} is not one of "
                         f"{AGGREGATES}")


def _segment_softmax_aggregate(g: AttnGraph, logits, msgs):
    alpha = segment_softmax(logits, g.dst, g.num_nodes)
    return segment_sum(msgs * alpha[:, None], g.dst, g.num_nodes)


def _global_shift(logits: torch.Tensor) -> torch.Tensor:
    """The largest logit (0 if it is not finite, or there is none):
    softmax by destination is invariant to one shift for all edges, and
    the largest bounds exp() above."""
    if logits.numel() == 0:
        return logits.new_zeros(())
    shift = logits.max()
    return torch.where(torch.isfinite(shift), shift, 0.0)


def attention_softmax_aggregate(g: AttnGraph, logits: torch.Tensor,
                                msgs: torch.Tensor,
                                aggregate: str = "mxu") -> torch.Tensor:
    """softmax(logits) over the edges of each destination, then the
    weighted sum of ``msgs`` [E, F] into [N, F]."""
    _check_aggregate(aggregate)
    if aggregate == "segment":
        return _segment_softmax_aggregate(g, logits, msgs)
    ex = torch.exp(logits - _global_shift(logits))[:, None]
    agg = scatter_sum(g.plan, torch.cat([ex, msgs * ex], dim=1))
    denom = agg[:, :1].clamp_min(torch.finfo(logits.dtype).tiny)
    return agg[:, 1:] / denom


def attention_softmax_aggregate_pair(g: AttnGraph, l1, m1, l2, m2,
                                     aggregate: str = "mxu"):
    """Two softmax-by-destination aggregations over the same graph in one
    segment sum of ``[exp1 | m1 exp1 | exp2 | m2 exp2]`` (one shift shared
    by both): the math of two ``attention_softmax_aggregate`` calls."""
    _check_aggregate(aggregate)
    if aggregate == "segment":
        return (_segment_softmax_aggregate(g, l1, m1),
                _segment_softmax_aggregate(g, l2, m2))
    shift = _global_shift(torch.maximum(l1, l2))
    ex1 = torch.exp(l1 - shift)[:, None]
    ex2 = torch.exp(l2 - shift)[:, None]
    f = m1.shape[1]
    agg = scatter_sum(g.plan, torch.cat([ex1, m1 * ex1, ex2, m2 * ex2], 1))
    tiny = torch.finfo(l1.dtype).tiny
    o1 = agg[:, 1:f + 1] / agg[:, :1].clamp_min(tiny)
    o2 = agg[:, f + 2:] / agg[:, f + 1:f + 2].clamp_min(tiny)
    return o1, o2


def _select(sel, table_b, table_u, index):
    """``table_u[index]`` on the unbalanced edges, ``table_b[index]`` on the
    others (one gather where the tables are one)."""
    if table_b is table_u:
        return table_b[index]
    return torch.where(sel, table_u[index], table_b[index])


def _attend(x1, x2, g: AttnGraph, alpha: nn.Linear, aggregate: str):
    """One attention propagate of x1 (balanced edges) and x2 (unbalanced
    edges): [N, F]."""
    sel = (g.edge_p == 1)[:, None]
    h_j = _select(sel, x1, x2, g.src)
    h_i = _select(sel, x1, x2, g.dst)
    logits = torch.tanh(alpha(torch.cat([h_j, h_i], dim=-1)))[:, 0]
    return attention_softmax_aggregate(g, logits, h_i, aggregate)


def _attend_pair(x1b, x2b, x1u, x2u, g: AttnGraph, alpha_b, alpha_u):
    """Two ``_attend`` calls of one graph fused: one gather of the
    lane-stacked [N, 4F] table at the sources and one at the destinations
    replace eight, and both aggregations ride one segment sum."""
    f = x1b.shape[1]
    T = torch.cat([x1b, x2b, x1u, x2u], dim=1)
    gs, gd = T[g.src], T[g.dst]
    sel = (g.edge_p == 1)[:, None]
    hj_b = torch.where(sel, gs[:, f:2 * f], gs[:, :f])
    hi_b = torch.where(sel, gd[:, f:2 * f], gd[:, :f])
    hj_u = torch.where(sel, gs[:, 3 * f:], gs[:, 2 * f:3 * f])
    hi_u = torch.where(sel, gd[:, 3 * f:], gd[:, 2 * f:3 * f])
    lb = torch.tanh(alpha_b(torch.cat([hj_b, hi_b], dim=-1)))[:, 0]
    lu = torch.tanh(alpha_u(torch.cat([hj_u, hi_u], dim=-1)))[:, 0]
    return attention_softmax_aggregate_pair(g, lb, hi_b, lu, hi_u)


def snea_graphs(pos_edge_index, neg_edge_index, num_nodes: int,
                device: DeviceLike = None
                ) -> Tuple[AttnGraph, AttnGraph, AttnGraph]:
    """(pos + loops, neg + loops, [pos + loops ; neg] with the negative
    edges flagged 1): the structures the reference rebuilds each forward,
    built once."""
    g_pos = build_attention_graph([(pos_edge_index, 0, True)], num_nodes,
                                  device)
    g_neg = build_attention_graph([(neg_edge_index, 0, True)], num_nodes,
                                  device)
    g_cat = build_attention_graph(
        [(pos_edge_index, 0, True), (neg_edge_index, 1, False)], num_nodes,
        device)
    return g_pos, g_neg, g_cat


class SNEAConv(nn.Module):
    """Signed attention conv (SNEA, AAAI'20): per-edge attention
    Linear(2 out, 1) -> tanh -> softmax by destination, the edge type
    selecting the balanced or unbalanced message.  Returns [balanced |
    unbalanced], each ``out_dim`` wide.  ``aggregate``: ``"mxu"`` (K1) or
    ``"segment"``; the first takes the fused pair path where
    ``4 out_dim <= PAIR_FUSION_MAX_LANES``."""

    def __init__(self, in_dim: int, out_dim: int, first_aggr: bool,
                 use_bias: bool = True, aggregate: str = "mxu", *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_aggregate(aggregate)
        device = resolve_device(device)
        self.in_dim, self.out_dim = in_dim, out_dim
        self.first_aggr, self.aggregate = first_aggr, aggregate
        self.lin_b = linear(in_dim, out_dim, use_bias, device, generator)
        self.lin_u = linear(in_dim, out_dim, use_bias, device, generator)
        self.alpha_b = linear(2 * out_dim, 1, True, device, generator,
                              init=xavier_normal)
        self.alpha_u = linear(2 * out_dim, 1, True, device, generator,
                              init=xavier_normal)

    @property
    def fused(self) -> bool:
        return (not self.first_aggr and self.aggregate == "mxu"
                and 4 * self.out_dim <= PAIR_FUSION_MAX_LANES)

    def forward(self, x: torch.Tensor, g_pos: AttnGraph, g_neg: AttnGraph,
                g_cat: AttnGraph) -> torch.Tensor:
        agg = self.aggregate
        if self.first_aggr:
            h_b, h_u = self.lin_b(x), self.lin_u(x)
            out_b = _attend(h_b, h_b, g_pos, self.alpha_b, agg)
            out_u = _attend(h_u, h_u, g_neg, self.alpha_u, agg)
        else:
            h_b, h_u = x[..., :self.in_dim], x[..., self.in_dim:]
            if self.fused:
                out_b, out_u = _attend_pair(
                    self.lin_b(h_b), self.lin_b(h_u), self.lin_u(h_u),
                    self.lin_u(h_b), g_cat, self.alpha_b, self.alpha_u)
            else:
                out_b = _attend(self.lin_b(h_b), self.lin_b(h_u), g_cat,
                                self.alpha_b, agg)
                out_u = _attend(self.lin_u(h_u), self.lin_u(h_b), g_cat,
                                self.alpha_u, agg)
        return torch.cat([out_b, out_u], dim=-1)
