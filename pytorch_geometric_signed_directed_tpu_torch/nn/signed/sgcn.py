"""SGCN: the signed GCN with a trainable input embedding and its
composite loss.

Counterpart of ``pytorch_geometric_signed_directed_tpu/nn/signed/
sgcn.py``.  The model owns its graph: ``prepare_sgcn_inputs`` splits the
[M, 3] signed edge list, builds the two mean Propagators (or the fused
union-edge-set DualPropagator) and, unless given one, the spectral input
embedding; ``SGCN.loss`` is Link_Sign_Entropy_Loss + lamb *
sign_structure_loss on host-sampled non-edges and triplets.
"""
from typing import Optional

import numpy as np
import torch
from torch import nn

from ...device import DeviceLike, resolve_device
from ...graph import mean_propagator
from ...ops.spmm import dual_propagator
from ...spectral.features import create_spectral_features
from ...utils.signed.link_sign_loss import (Link_Sign_Entropy_Loss,
                                            sign_structure_loss)
from .sgcn_conv import SGCNConv


def register_embedding(module: nn.Module, init_emb, init_emb_grad: bool,
                       device: torch.device) -> None:
    """``module.x``: a copy of ``init_emb`` (an array or a tensor; training
    must not write into the caller's), a parameter when ``init_emb_grad``,
    else a buffer left out of the state_dict."""
    if isinstance(init_emb, torch.Tensor):
        x = init_emb.detach().to(device, torch.float32).clone()
    else:
        x = torch.tensor(np.asarray(init_emb, np.float32), device=device)
    if init_emb_grad:
        module.x = nn.Parameter(x)
    else:
        module.register_buffer("x", x, persistent=False)


def split_signed_edges(edge_index_s: np.ndarray):
    """[M, 3] (src, dst, sign) -> (pos_edge_index [2, P], neg [2, Q])."""
    edge_index_s = np.asarray(edge_index_s)
    pos = edge_index_s[edge_index_s[:, 2] > 0][:, :2].T
    neg = edge_index_s[edge_index_s[:, 2] < 0][:, :2].T
    return pos.astype(np.int64), neg.astype(np.int64)


def sgcn_dual_propagator(pos_edge_index, neg_edge_index, node_num: int,
                         mode: str = "mxu", device: DeviceLike = None):
    """The two mean propagators fused into one operator over the union of
    the edge sets: val_a = 1/deg_pos(dst) on the positive edges (0 on the
    negative ones), val_b the other way, duplicates kept, so one apply
    gives [P_pos x_a | P_neg x_b].  A layer then makes half the applies
    (the first 1 instead of 2, the others 2 instead of 4).  None on the
    dense tier, where fusing buys nothing."""
    rp, cp = np.asarray(pos_edge_index[1]), np.asarray(pos_edge_index[0])
    rn, cn = np.asarray(neg_edge_index[1]), np.asarray(neg_edge_index[0])

    def inv_count(r):
        cnt = np.bincount(r, minlength=node_num).astype(np.float64)
        cnt[cnt == 0] = 1.0
        return 1.0 / cnt[r]

    va = np.concatenate([inv_count(rp), np.zeros(len(rn))])
    vb = np.concatenate([np.zeros(len(rp)), inv_count(rn)])
    return dual_propagator(np.concatenate([rp, rn]), np.concatenate([cp, cn]),
                           va, vb, num_nodes=node_num, mode=mode,
                           device=device)


def prepare_sgcn_inputs(node_num: int, edge_index_s, in_dim: int = 64,
                        init_emb: Optional[np.ndarray] = None,
                        mode: str = "auto", fused: bool = False,
                        device: DeviceLike = None):
    """(pos_edge_index, neg_edge_index, init_emb, P_pos, P_neg): the split
    edges, the input embedding (``create_spectral_features`` unless given)
    and the two mean Propagators, or with ``fused`` the DualPropagator of
    ``sgcn_dual_propagator`` (``mode="auto"`` taken as the kernel tier)
    and None, where the tier fuses."""
    pos_edge_index, neg_edge_index = split_signed_edges(edge_index_s)
    if init_emb is None:
        init_emb = create_spectral_features(pos_edge_index, neg_edge_index,
                                            node_num, in_dim,
                                            device=resolve_device(device))
    if fused:
        D = sgcn_dual_propagator(pos_edge_index, neg_edge_index, node_num,
                                 mode="mxu" if mode == "auto" else mode,
                                 device=device)
        if D is not None:
            return pos_edge_index, neg_edge_index, init_emb, D, None
    P_pos = mean_propagator(pos_edge_index, node_num, mode=mode,
                            device=device)
    P_neg = mean_propagator(neg_edge_index, node_num, mode=mode,
                            device=device)
    return pos_edge_index, neg_edge_index, init_emb, P_pos, P_neg


class SGCN(nn.Module):
    """SGCN (ICDM'18): a first SGCNConv from the input embedding, then
    ``layer_num - 1`` more, each followed by tanh.  The embedding
    ``init_emb`` [node_num, in_dim] is a parameter (``x``) when
    ``init_emb_grad``, else a constant buffer."""

    def __init__(self, node_num: int, in_dim: int = 64, out_dim: int = 64,
                 layer_num: int = 2, lamb: float = 5.0,
                 norm_emb: bool = False, init_emb_grad: bool = False,
                 init_emb: Optional[np.ndarray] = None, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if init_emb is None:
            raise ValueError("SGCN needs init_emb; prepare_sgcn_inputs "
                             "builds the spectral one")
        self.node_num, self.lamb = node_num, lamb
        register_embedding(self, init_emb, init_emb_grad, device)
        half = out_dim // 2
        self.conv1 = SGCNConv(in_dim, half, first_aggr=True, device=device,
                              generator=generator)
        self.convs = nn.ModuleList([
            SGCNConv(half, half, first_aggr=False, norm_emb=norm_emb,
                     device=device, generator=generator)
            for _ in range(layer_num - 1)])
        self.lsp_loss = Link_Sign_Entropy_Loss(out_dim, device=device,
                                               generator=generator)

    def forward(self, P_pos, P_neg=None) -> torch.Tensor:
        z = torch.tanh(self.conv1(self.x, P_pos, P_neg))
        for conv in self.convs:
            z = torch.tanh(conv(z, P_pos, P_neg))
        return z

    def loss(self, P_pos, P_neg, pos_edge_index, neg_edge_index,
             none_edge_index, pos_triplets, neg_triplets) -> torch.Tensor:
        """nll + lamb * the structure loss; the index arrays (numpy or
        tensors) come from ``utils.signed.negative_sampling`` and
        ``structured_negative_sampling``."""
        return entropy_and_structure_loss(
            self(P_pos, P_neg), self.lsp_loss, self.lamb, pos_edge_index,
            neg_edge_index, none_edge_index, pos_triplets, neg_triplets)


def entropy_and_structure_loss(z, lsp_loss, lamb, pos_edge_index,
                               neg_edge_index, none_edge_index, pos_triplets,
                               neg_triplets) -> torch.Tensor:
    """SGCN's and SNEA's loss of the embedding z: Link_Sign_Entropy_Loss +
    lamb * sign_structure_loss; the index arrays may be numpy arrays or
    tensors."""

    def index(a):
        return torch.as_tensor(a, device=z.device)

    nll = lsp_loss(z, index(pos_edge_index), index(neg_edge_index),
                   index(none_edge_index))
    structure = sign_structure_loss(z, [index(a) for a in pos_triplets],
                                    [index(a) for a in neg_triplets])
    return nll + lamb * structure
