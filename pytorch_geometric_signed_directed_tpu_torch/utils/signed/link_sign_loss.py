"""Link-sign losses of SGCN, SNEA, SiGAT and SDGNN.

Counterpart of ``pytorch_geometric_signed_directed_tpu/utils/signed/
link_sign_loss.py``.  Losses with weights are ``nn.Module``s whose Linear
layers take flax's ``nn.Dense`` defaults (lecun-normal weight, zero bias)
from ``generator``; the sampled index arrays (``utils.signed.sampling``)
are drawn on the host and passed in.  A fixed edge list may come as
``PlannedEdges`` (``plan_edges``): its gathers' backward is then K1 (see
``ops.scatter.gather_rows``) rather than a sort and an accumulate a step.
"""
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...device import DeviceLike, resolve_device
from ...instrument import layer
from ...nn.inits import linear
from ...ops.scatter import GatherPlan, build_gather_plan, gather_rows


@dataclass(frozen=True)
class PlannedEdges:
    """An edge list [2, E] held on the device with the plans of the
    gathers at both of its ends."""

    src: GatherPlan
    dst: GatherPlan

    @property
    def shape(self):
        return (2, self.src.index.numel())


def plan_edges(edge_index, num_nodes: int,
               device: DeviceLike = None) -> PlannedEdges:
    """``edge_index`` [2, E] (an array or a tensor) planned once, for the
    losses to take in place of the edge list at every step."""
    return PlannedEdges(*(build_gather_plan(edge_index[i], num_nodes, device)
                          for i in range(2)))


def _bce_logits(logits, target_ones: bool, weight=None) -> torch.Tensor:
    """Summed binary cross-entropy of logits against all-ones (or zeros)."""
    loss = F.softplus(-logits) if target_ones else F.softplus(logits)
    if weight is not None:
        loss = loss * weight
    return loss.sum()


def _ends(z, edge_index):
    """The rows of ``z`` at the sources and at the destinations."""
    if isinstance(edge_index, PlannedEdges):
        return (gather_rows(z, edge_index.src),
                gather_rows(z, edge_index.dst))
    return z[edge_index[0]], z[edge_index[1]]


def _pair(z, edge_index) -> torch.Tensor:
    return torch.cat(_ends(z, edge_index), dim=1)


def _dot(z, edge_index) -> torch.Tensor:
    src, dst = _ends(z, edge_index)
    return (src * dst).sum(dim=1)


class Sign_Triangle_Loss(nn.Module):
    """BCE of one learned edge score, each edge weighted by its triangle
    count (``w_pos`` / ``w_neg``, gathered on the host)."""

    def __init__(self, emb_dim: int, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = linear(2 * emb_dim, 1, True, resolve_device(device),
                             generator)

    @layer("loss.sign_triangle", mark_inputs=False)
    def forward(self, z, pos_edge_index, neg_edge_index, w_pos, w_neg):
        rs1 = self.linear(_pair(z, pos_edge_index))
        rs2 = self.linear(_pair(z, neg_edge_index))
        return (_bce_logits(rs1, True, w_pos.reshape(-1, 1))
                + _bce_logits(rs2, False, w_neg.reshape(-1, 1)))


class Sign_Direction_Loss(nn.Module):
    """SDGNN's hinge on the difference of two sigmoid node scores: at most
    -0.5 along a positive edge, at least 0.5 along a negative one."""

    def __init__(self, emb_dim: int, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.score_function1 = linear(emb_dim, 1, True, device, generator)
        self.score_function2 = linear(emb_dim, 1, True, device, generator)

    def _diff(self, z, edge_index):
        src, dst = _ends(z, edge_index)
        return (torch.sigmoid(self.score_function1(src))
                - torch.sigmoid(self.score_function2(dst)))

    @layer("loss.sign_direction", mark_inputs=False)
    def forward(self, z, pos_edge_index, neg_edge_index):
        d = self._diff(z, pos_edge_index)
        pos_loss = ((torch.where(d > -0.5, -0.5, d) - d) ** 2).sum()
        d = self._diff(z, neg_edge_index)
        neg_loss = ((torch.where(d > 0.5, d, 0.5) - d) ** 2).sum()
        return pos_loss + neg_loss


@layer("loss.sign_product", mark_inputs=False)
def sign_product_entropy_loss(z, pos_edge_index, neg_edge_index):
    """BCE of the embeddings' dot products: positive edges toward 1,
    negative ones toward 0."""
    return (_bce_logits(_dot(z, pos_edge_index), True)
            + _bce_logits(_dot(z, neg_edge_index), False))


class Sign_Product_Entropy_Loss:
    def __call__(self, z, pos_edge_index, neg_edge_index):
        return sign_product_entropy_loss(z, pos_edge_index, neg_edge_index)


def link_sign_product_loss(z, pos_edge_index, neg_edge_index):
    """SiGAT's log-sigmoid of the dot products, the negative class weighted
    by C = |E+| / |E-|."""
    loss_pos = -F.logsigmoid(_dot(z, pos_edge_index)).sum()
    loss_neg = -F.logsigmoid(-_dot(z, neg_edge_index)).sum()
    return loss_pos + loss_neg * (pos_edge_index.shape[1]
                                  / neg_edge_index.shape[1])


class Link_Sign_Product_Loss:
    def __call__(self, z, pos_edge_index, neg_edge_index):
        return link_sign_product_loss(z, pos_edge_index, neg_edge_index)


class Link_Sign_Entropy_Loss(nn.Module):
    """SGCN's 3-class (positive / negative / no edge) discriminator: the
    mean NLL of each class on its edges, averaged.  ``none_edge_index``
    holds the sampled non-edges (``utils.signed.negative_sampling``)."""

    def __init__(self, emb_dim: int, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = linear(2 * emb_dim, 3, True, resolve_device(device),
                             generator)

    def forward(self, z, pos_edge_index, neg_edge_index, none_edge_index):
        nll = 0.0
        for cls, ei in enumerate((pos_edge_index, neg_edge_index,
                                  none_edge_index)):
            logp = torch.log_softmax(self.linear(_pair(z, ei)), dim=1)
            nll = nll - logp[:, cls].mean()
        return nll / 3.0


def sign_structure_loss(z, pos_samples, neg_samples):
    """The triplet loss of balance theory on sampled (i, j, k): i nearer a
    positive neighbour j than a non-neighbour k, and a negative neighbour
    j farther from i than k (``utils.signed.
    structured_negative_sampling``)."""
    def sq(a, b):
        return ((z[a] - z[b]) ** 2).sum(dim=1)

    def hinge(v):
        # maximum, not clamp: half the gradient at 0, as jnp.clip
        return torch.maximum(v, torch.zeros_like(v)).mean()

    i, j, k = pos_samples
    loss_1 = hinge(sq(i, j) - sq(i, k))
    i, j, k = neg_samples
    return loss_1 + hinge(sq(i, k) - sq(i, j))


class Sign_Structure_Loss:
    def __call__(self, z, pos_samples, neg_samples):
        return sign_structure_loss(z, pos_samples, neg_samples)
