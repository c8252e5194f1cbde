"""Motif edge lists of SiGAT and SDGNN (host-side, numpy and scipy).

Counterpart of ``pytorch_geometric_signed_directed_tpu/nn/signed/
motifs.py``, the same arrays for the same input.  The reference builds 38
(SiGAT) and 4 (SDGNN) motif edge lists with Python set intersections; the
16 triangle counts are sparse boolean matrix products:

    d1 = [PP, PN, NP, NN]          (out(u) ∩ in(v))
    d2 = [PPt, PNt, NPt, NNt]      (out(u) ∩ out(v))
    d3 = [PtPt, PtNt, NtPt, NtNt]  (in(u)  ∩ out(v))
    d4 = [PtP, PtN, NtP, NtN]      (in(u)  ∩ in(v))

with P / N the boolean positive / negative directed adjacencies.  Unique
keys come from one sort (``ops.coalesce.sorted_unique``) and membership
from a sorted search (``utils.signed.sampling``): numpy >= 2.3 answers
``np.unique`` and ``np.isin`` from a hash table, many times slower.
"""
from typing import List, Tuple

import numpy as np
import scipy.sparse as sp

from ...instrument import span
from ...ops.coalesce import sorted_unique
from ...utils.signed.sampling import _member


def _bool_adjs(edge_index_s, num_nodes):
    e = np.asarray(edge_index_s)
    pos = e[e[:, 2] > 0][:, :2]
    neg = e[e[:, 2] < 0][:, :2]

    def mat(pairs):
        if len(pairs) == 0:
            return sp.csr_matrix((num_nodes, num_nodes), dtype=np.float64)
        M = sp.coo_matrix((np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])),
                          shape=(num_nodes, num_nodes)).tocsr()
        M.data = np.minimum(M.data, 1.0)
        return M

    return mat(pos), mat(neg), pos, neg


def _tri_products(P: sp.csr_matrix, N: sp.csr_matrix) -> List[sp.csr_matrix]:
    Pt, Nt = P.T.tocsr(), N.T.tocsr()
    return [
        P @ P, P @ N, N @ P, N @ N,
        P @ Pt, P @ Nt, N @ Pt, N @ Nt,
        Pt @ Pt, Pt @ Nt, Nt @ Pt, Nt @ Nt,
        Pt @ P, Pt @ N, Nt @ P, Nt @ N,
    ]


def _lookup(M, pairs):
    if len(pairs) == 0:
        return np.zeros(0)
    return np.asarray(M[pairs[:, 0], pairs[:, 1]]).ravel()


def _uniq(pairs, num_nodes):
    """The distinct pairs of [E, 2] ``pairs`` as [2, U], in key order."""
    if len(pairs) == 0:
        return np.zeros((2, 0), np.int64)
    k = sorted_unique(pairs[:, 0].astype(np.int64) * num_nodes + pairs[:, 1])
    return np.stack([k // num_nodes, k % num_nodes])


def sigat_edge_lists(edge_index_s, num_nodes: int) -> List[np.ndarray]:
    """The 38 SiGAT motif edge lists ([2, E] arrays) in the reference's
    order: 6 base + 16 positive-triangle + 16 negative-triangle; the span
    ``pgsd.prep.motifs``."""
    with span("prep.motifs", rows=num_nodes, graphs=38):
        return _sigat_edge_lists(edge_index_s, num_nodes)


def _sigat_edge_lists(edge_index_s, num_nodes: int) -> List[np.ndarray]:
    P, N, pos, neg = _bool_adjs(edge_index_s, num_nodes)
    pos_und = np.vstack([pos, pos[:, [1, 0]]])
    neg_und = np.vstack([neg, neg[:, [1, 0]]])
    n = num_nodes
    base = [_uniq(pos_und, n), _uniq(pos, n), _uniq(pos[:, [1, 0]], n),
            _uniq(neg_und, n), _uniq(neg, n), _uniq(neg[:, [1, 0]], n)]
    mats = _tri_products(P, N)
    pos_u = base[1].T  # the distinct directed positive edges
    neg_u = base[4].T
    adds1 = [pos_u[_lookup(M, pos_u) > 0].T for M in mats]
    adds2 = [neg_u[_lookup(M, neg_u) > 0].T for M in mats]
    return base + adds1 + adds2


_SDGNN_MASK_POS = np.array([1, 0, 0, 0, 1, 0, 0, 1, 0, 0, 0, 1, 1, 0, 0, 1])
_SDGNN_MASK_NEG = np.array([0, 1, 1, 0, 0, 0, 1, 0, 0, 1, 1, 0, 0, 1, 0, 0])


def sdgnn_edge_lists(edge_index_s, num_nodes: int
                     ) -> Tuple[List[np.ndarray], sp.csc_matrix]:
    """SDGNN's 4 motif edge lists [pos_out, pos_in, neg_out, neg_in] and
    the triangle-count weight matrix; the span ``pgsd.prep.motifs``."""
    with span("prep.motifs", rows=num_nodes, graphs=4):
        return _sdgnn_edge_lists(edge_index_s, num_nodes)


def _sdgnn_edge_lists(edge_index_s, num_nodes: int):
    P, N, pos, neg = _bool_adjs(edge_index_s, num_nodes)
    n = num_nodes
    edge_lists = [_uniq(pos, n), _uniq(pos[:, [1, 0]], n),
                  _uniq(neg, n), _uniq(neg[:, [1, 0]], n)]
    mats = _tri_products(P, N)
    pos_u = edge_lists[0].T
    neg_u = edge_lists[2].T
    counts_pos = sum(w * _lookup(M, pos_u)
                     for w, M in zip(_SDGNN_MASK_POS, mats))
    counts_neg = sum(w * _lookup(M, neg_u)
                     for w, M in zip(_SDGNN_MASK_NEG, mats))
    # the reference writes its weight dict positive loop first, then
    # negative, so a pair carrying both signs keeps only the negative count
    if len(pos_u) and len(neg_u):
        pos_keys = pos_u[:, 0] * n + pos_u[:, 1]
        neg_keys = neg_u[:, 0] * n + neg_u[:, 1]   # sorted and distinct
        keep = ~_member(pos_keys, neg_keys)
        pos_u = pos_u[keep]
        counts_pos = np.atleast_1d(counts_pos)[keep]
    row = np.concatenate([pos_u[:, 0], neg_u[:, 0]])
    col = np.concatenate([pos_u[:, 1], neg_u[:, 1]])
    val = np.concatenate([np.atleast_1d(counts_pos),
                          np.atleast_1d(counts_neg)])
    tri_weight = sp.csc_matrix((val, (row, col)),
                               shape=(num_nodes, num_nodes))
    return edge_lists, tri_weight
