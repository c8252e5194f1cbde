"""Polarized signed SBM: an ambient random signed graph with SSBM
communities embedded in it (host-side numpy/scipy).

Counterpart of ``pytorch_geometric_signed_directed_tpu/data/
polarized_ssbm.py``; the same ``np.random.Generator`` state gives identical
arrays.  The ambient pairs go through a Python set (O(N^2 p) memory and
time), which suits the few hundred nodes the tests use.
"""
import math
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph  # noqa: F401  (binds sp.csgraph)

from .ssbm import SSBM, geometric_sizes


def _symmetric(ids: np.ndarray, n: int) -> sp.lil_matrix:
    """The symmetric 0/1 matrix of pair ids ``row * n + col``."""
    r, c = ids // n, ids % n
    return sp.coo_matrix((np.ones(2 * len(r)),
                          (np.concatenate([r, c]), np.concatenate([c, r]))),
                         shape=(n, n)).tolil()


def polarized_SSBM(total_n: int = 100, num_com: int = 3, N: int = 30,
                   K: int = 2, p: float = 0.1, eta: float = 0.1,
                   size_ratio: float = 1,
                   rng: Optional[np.random.Generator] = None
                   ) -> Tuple[Tuple[sp.spmatrix, sp.spmatrix],
                              np.ndarray, np.ndarray]:
    """((A_p, A_n), labels, conflict_groups) of the largest connected
    component: ``num_com`` SSBM communities of ~``N`` nodes, each with
    ``K`` factions, inside an ambient graph of ``total_n`` nodes, node ids
    permuted by a fixed ``RandomState(2020)`` permutation, nodes of degree
    1 or 2 given extra edges."""
    rng = rng or np.random.default_rng()
    # ambient graph: ordered pairs whose reverse was not drawn, half of
    # them positive, half negative, both symmetrized
    select_num = math.floor(total_n * p / 4 * total_n)
    pair_ids = rng.choice(total_n * total_n, size=min(
        2 * select_num, total_n * total_n), replace=False)
    drawn = set(pair_ids.tolist())
    rev_ids = (pair_ids % total_n) * total_n + pair_ids // total_n
    keep = np.array([rid not in drawn for rid in rev_ids.tolist()])
    ambient = rev_ids[keep]
    half = len(ambient) // 2
    big_p = _symmetric(ambient[:half], total_n)
    big_n = _symmetric(ambient[half:2 * half], total_n)
    big_labels = np.zeros(total_n)
    big_groups = np.zeros(total_n)

    size = geometric_sizes(num_com * N, num_com, size_ratio)
    at = 0
    for com in range(num_com):
        s = size[com]
        (A_p, A_n), labels = SSBM(n=s, k=K, pin=p, etain=eta,
                                  size_ratio=size_ratio, rng=rng)
        big_p[at:at + s, at:at + s] = A_p
        big_n[at:at + s, at:at + s] = A_n
        big_labels[at:at + s] = labels + (2 * com + 1)
        big_groups[at:at + s] = com + 1
        at += s

    perm = np.random.RandomState(2020).permutation(total_n)

    def permute(M):
        M = M.tocoo()
        return sp.coo_matrix((M.data, (perm[M.row], perm[M.col])),
                             shape=(total_n, total_n)).tocsc()

    big_p, big_n = permute(big_p), permute(big_n)
    labels_all = np.zeros(total_n)
    groups_all = np.zeros(total_n)
    labels_all[perm] = big_labels
    groups_all[perm] = big_groups

    # the largest connected component of the signed graph
    _, comp = sp.csgraph.connected_components((big_p - big_n).tocsr(),
                                              directed=False)
    keep = np.nonzero(comp == np.bincount(comp).argmax())[0]
    A_p = sp.lil_matrix(big_p[keep][:, keep])
    A_n = sp.lil_matrix(big_n[keep][:, keep])
    labels = labels_all[keep]
    groups = groups_all[keep]

    # nodes of degree 1 or 2 get 2 or 1 extra edges to nodes they miss
    A_bar = sp.lil_matrix(A_p + A_n)
    row_sum = np.asarray(A_bar.sum(axis=1)).ravel()
    n_new = len(labels)
    if (row_sum <= 2).sum():
        for i in np.arange(n_new)[row_sum <= 2]:
            row = A_bar[i].toarray().ravel()
            deg = int((row != 0).sum())
            if deg not in (1, 2):
                continue
            n_add = 2 if deg == 1 else 1
            targets = rng.choice(np.arange(n_new)[row == 0], size=n_add,
                                 replace=False)
            flips = rng.binomial(1, eta, size=n_add)
            for j, flip in zip(targets, flips):
                A_bar[i, j] = 1
                A_bar[j, i] = 1
                if groups[i] == groups[j]:
                    negative = (flip if labels[j] == labels[i]
                                else not flip)
                else:
                    negative = rng.binomial(1, 0.5)
                target = A_n if negative else A_p
                target[i, j] = 1
                target[j, i] = 1
    return (A_p, A_n), labels, groups
