"""Fused motif attention: G single-head GATs over G motif graphs as ONE
gather and ONE segment sum on a [G N] row space.

Counterpart of ``pytorch_geometric_signed_directed_tpu/nn/signed/
motif_stack.py``.  SiGAT runs 38 motif GATConvs over the same x and SDGNN
4 a layer, each a small gather, softmax and segment sum.  Stacked:

  * the per-motif Linear weights become one [G, in, out] batched product;
  * motif g's edge (s, d) becomes (g N + s, g N + d), so all G
    aggregations ride one destination CSR over G N rows (destinations of
    two motifs never share a row, so the softmax of each (motif, node) is
    the per-motif one);
  * ``motif_attend``'s backward lands every scatter on a CSR: [dT |
    da_src] in one segment sum over a second, source-keyed CSR (width
    F + 1), and da_dst in one over the destination CSR (width 1).  All
    three sums are K1 ``csr_scatter_sum``.

The two sums of width F + 1 read their messages by index (K1's indexed
loader): the forward's ``[ex | ex T[src]]`` from T, the backward's
``[dpre | alpha dout[dst]]`` from dout, in the source CSR's slot order.
The logits' gradient ``dpre`` is one edge kernel
(``ops.cuda.attend_grad``).  So no [E, F] edge tensor is gathered,
concatenated or reordered: only [E] scalars are.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ... import instrument
from ...device import DeviceLike, resolve_device
from ...ops.cuda.attend_grad import attend_logit_grad
from ...ops.cuda.scatter_csr import csr_scatter_sum
from ...ops.scatter import ScatterPlan, build_scatter_plan
from ..inits import glorot, zeros
from .gat_conv import leaky_relu
from .snea_conv import ATTENDS, AttnGraph, _global_shift


@dataclass(frozen=True)
class MotifStackGraph:
    """G motif graphs as one ``AttnGraph`` ``g`` over G N rows, plus
    ``src_plan``, a CSR of the same edges keyed by source over G N + 1
    rows (the last, the JAX plan's trash row for padding slots, is empty
    here), and ``src_perm`` [E] int64, the forward edge of each
    source-CSR slot.  ``num_nodes`` is N, ``num_graphs`` G.
    ``dst_by_src`` [E] int64 is the destination of each source-CSR
    slot's edge: the table row the backward's sum by source reads (a
    field the JAX plan does not need: its backward gathers)."""

    g: AttnGraph
    src_plan: ScatterPlan
    src_perm: torch.Tensor
    num_nodes: int
    num_graphs: int
    dst_by_src: torch.Tensor


def build_motif_stack(edge_lists: List[np.ndarray], num_nodes: int,
                      device: DeviceLike = None) -> MotifStackGraph:
    """Concatenate G motif edge lists with per-motif row offsets: as
    ``gat_graph`` per motif, self-edges dropped, then a self-loop for every
    node appended."""
    device = resolve_device(device)
    n, G = num_nodes, len(edge_lists)
    loops = np.arange(n, dtype=np.int64)
    srcs, dsts = [], []
    for i, edge_index in enumerate(edge_lists):
        edge_index = np.asarray(edge_index, np.int64).reshape(2, -1)
        edge_index = edge_index[:, edge_index[0] != edge_index[1]]
        srcs.append(np.concatenate([edge_index[0], loops]) + i * n)
        dsts.append(np.concatenate([edge_index[1], loops]) + i * n)
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    plan = build_scatter_plan(dst, G * n, device=device)
    g = AttnGraph(src=torch.from_numpy(src).to(device), dst=plan.row_ids,
                  edge_p=torch.zeros(len(src), dtype=torch.int32,
                                     device=device),
                  plan=plan, num_nodes=G * n)
    src_perm = np.argsort(src, kind="stable")
    src_plan = build_scatter_plan(src[src_perm], G * n + 1, device=device)
    src_perm = torch.from_numpy(src_perm).to(device)
    return MotifStackGraph(g=g, src_plan=src_plan, src_perm=src_perm,
                           num_nodes=n, num_graphs=G,
                           dst_by_src=plan.row_ids[src_perm])


def _edge_terms(slope, ms: MotifStackGraph, a_src, a_dst):
    """The [E] pre-activations and their exponentials, shifted by one
    detached constant."""
    g = ms.g
    pre = a_src[g.src] + a_dst[g.dst]
    logit = leaky_relu(pre, slope)
    return pre, torch.exp(logit - _global_shift(logit))


class _MotifAttend(torch.autograd.Function):

    @staticmethod
    def forward(ctx, T, a_src, a_dst, ms, slope):
        T = T.contiguous()
        pre, ex = _edge_terms(slope, ms, a_src, a_dst)
        plan = ms.g.plan
        # [ex | ex T[src]] by destination, read from T
        agg = csr_scatter_sum(plan.rowptr, T, plan.split, index=ms.g.src,
                              weight=ex, scalar=ex)
        S = agg[:, :1].clamp_min(torch.finfo(T.dtype).tiny)
        out = agg[:, 1:] / S
        ctx.ms, ctx.slope = ms, slope
        # the [E] edge terms are kept, not recomputed: 8 bytes an edge
        ctx.save_for_backward(T, out, S, pre, ex)
        return out

    @staticmethod
    def backward(ctx, dout):
        T, out, S, pre, ex = ctx.saved_tensors
        ms, slope = ctx.ms, ctx.slope
        g, GN = ms.g, ms.g.num_nodes
        dout = dout.contiguous()
        alpha = ex / S[g.dst, 0]
        # the logit gradient of a softmax-weighted sum
        dpre = attend_logit_grad(g.dst, g.src, T, out, dout, alpha, pre,
                                 slope)
        # [dpre | alpha dout[dst]] by source, read from dout (the [E]
        # scalars put in the source CSR's slot order)
        p = ms.src_perm
        o2 = csr_scatter_sum(ms.src_plan.rowptr, dout, ms.src_plan.split,
                             index=ms.dst_by_src, weight=alpha[p],
                             scalar=dpre[p])
        da_dst = csr_scatter_sum(g.plan.rowptr, dpre[:, None].contiguous(),
                                 g.plan.split)[:, 0]
        return o2[:GN, 1:], o2[:GN, 0], da_dst, None, None


def motif_attend(slope: float, ms: MotifStackGraph, T: torch.Tensor,
                 a_src: torch.Tensor, a_dst: torch.Tensor) -> torch.Tensor:
    """One single-head GAT attend over the stacked row space: logits =
    leaky_relu(a_src[src] + a_dst[dst]), softmax by destination, the
    weighted sum of T[src]; [G N, F].  One K1 call forward, two backward
    (with the edge kernel); G aggregates in ``snea_conv.ATTENDS``."""
    ATTENDS["mxu"] += ms.num_graphs
    return _MotifAttend.apply(T, a_src, a_dst, ms, slope)


def stack_state_dict(state_dict):
    """A per-motif SiGAT's or SDGNN's state_dict as its fused form's: the
    GATConvs ``<prefix>aggs.i`` become ``<prefix>agg_stack`` (``kernel``
    [G, in, out] from the Linear weights [out, in], ``att_src``,
    ``att_dst`` and ``bias`` stacked in motif order); the rest is kept."""
    out, convs = {}, {}
    for k, v in state_dict.items():
        head, sep, tail = k.partition("aggs.")
        if not sep:
            out[k] = v
            continue
        i, name = tail.split(".", 1)
        convs.setdefault(head, {}).setdefault(name, {})[int(i)] = v
    for head, leaves in convs.items():
        def stacked(name, f=lambda v: v):
            return torch.stack([f(leaves[name][i])
                                for i in sorted(leaves[name])])
        out[head + "agg_stack.kernel"] = stacked("linear.weight",
                                                 lambda v: v.T)
        for name in ("att_src", "att_dst", "bias"):
            out[head + "agg_stack." + name] = stacked(name)
    return out


class MotifGATStack(nn.Module):
    """G parallel single-head GATs sharing one CSR; per motif the math of
    ``GATConv``.  Parameters: ``kernel`` [G, in, out], ``att_src`` and
    ``att_dst`` [G, out, 1], ``bias`` [G, out]."""

    def __init__(self, in_dim: int, out_dim: int, num_graphs: int,
                 negative_slope: float = 0.2, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        G, f = num_graphs, out_dim
        self.negative_slope = negative_slope
        # flax's xavier counts the motif axis in both fans: gain^2 = 1/G
        self.kernel = nn.Parameter(
            glorot((G, in_dim, f), generator, gain_sq=1.0 / G).to(device))
        self.att_src = nn.Parameter(
            glorot((G, f, 1), generator, gain_sq=1.0 / G).to(device))
        self.att_dst = nn.Parameter(
            glorot((G, f, 1), generator, gain_sq=1.0 / G).to(device))
        self.bias = nn.Parameter(zeros((G, f)).to(device))

    @instrument.layer("nn.motif_gat_stack")
    def forward(self, x: torch.Tensor, stack: MotifStackGraph
                ) -> torch.Tensor:
        """[G, N, out]: each motif's attend of x, + its bias."""
        G, n = stack.num_graphs, stack.num_nodes
        f = self.kernel.shape[-1]
        if G != self.kernel.shape[0]:
            raise ValueError(f"the stack holds {G} motif graphs, the layer "
                             f"{self.kernel.shape[0]}")
        H = torch.einsum("ni,gif->gnf", x, self.kernel)
        a_src = torch.einsum("gnf,gfo->gn", H, self.att_src).reshape(G * n)
        a_dst = torch.einsum("gnf,gfo->gn", H, self.att_dst).reshape(G * n)
        out = motif_attend(self.negative_slope, stack, H.reshape(G * n, f),
                           a_src, a_dst)
        return out.reshape(G, n, f) + self.bias[:, None, :]

    @staticmethod
    def concat(x: torch.Tensor, outs: torch.Tensor) -> torch.Tensor:
        """[x | motif_0 | motif_1 | ...] per node: the layout of the
        per-motif loop's concatenation."""
        G, n, f = outs.shape
        return torch.cat([x, outs.permute(1, 0, 2).reshape(n, G * f)], dim=1)
