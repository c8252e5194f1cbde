"""DiGCN's personalized-PageRank adjacency builders (host side, numpy and
scipy).

Counterpart of ``pytorch_geometric_signed_directed_tpu/spectral/appr.py``:
the same arrays for the same input.

  * fast_appr_power      — sparse power-iteration PageRank and the
                           pi-symmetrized operator
  * cal_fast_appr        — its normalized graph view (DiGCL)
  * appr_directed_adj    — the exact PPR adjacency (dense teleport matrix
                           and its left eigenvector; O(N^3))
  * second_directed_adj  — the second-order proximity adjacency (dense)
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy
import scipy.sparse as sp


def _add_self_loops(edge_index, edge_weight, num_nodes, fill_value=1.0):
    loops = np.arange(num_nodes)
    row = np.concatenate([np.asarray(edge_index[0]), loops])
    col = np.concatenate([np.asarray(edge_index[1]), loops])
    w = np.concatenate([edge_weight, np.full(num_nodes, fill_value)])
    return np.stack([row, col]), w


def _sym_norm(edge_index, edge_weight, num_nodes):
    """deg^-1/2[row] * w * deg^-1/2[col] with out-degree by row."""
    deg = np.zeros(num_nodes)
    deg = deg + np.bincount(edge_index[0], weights=edge_weight,
                            minlength=len(deg))
    dinv = np.zeros_like(deg)
    nz = deg > 0
    dinv[nz] = deg[nz] ** -0.5
    return dinv[edge_index[0]] * edge_weight * dinv[edge_index[1]]


def fast_appr_power(A: sp.spmatrix, alpha: float = 0.1, max_iter: int = 100,
                    tol: float = 1e-6, personalize=None):
    """Power-iteration PageRank + pi-symmetrized PPR operator.

    Returns (L, pi) with L = (Pi^1/2 P Pi^-1/2 + Pi^-1/2 P^T Pi^1/2)/2 for
    the row-stochastic P = D^-1 A.  Matches the numerics of the original
    library's lazy-teleport formulation: the walk damps by
    (1-alpha)/(1+alpha)-style weights with every node teleporting at rate
    alpha*(1+alpha) and dangling nodes dumping their whole transition mass
    into the restart distribution.

    Implementation is flat-vector / scaled-CSR: P is built by scaling CSR
    data with the inverse out-degree, the iteration runs on 1-D vectors
    (the teleport term is a scalar dot), and the symmetrization uses the
    transpose identity  Pi^-1/2 P^T Pi^1/2 = (Pi^1/2 P Pi^-1/2)^T  so one
    COO data-scaling + (M + M^T)/2 replaces four diagonal matmuls.
    """
    n = A.shape[0]
    A = sp.csr_matrix(A)
    out_deg = np.asarray(A.sum(axis=1)).ravel().astype(np.float64)
    dangling = out_deg == 0.0
    inv_deg = np.divide(1.0, out_deg, out=np.zeros_like(out_deg),
                        where=~dangling)

    # restart distribution and per-node teleport weights
    if personalize is None:
        restart = np.full(n, 1.0 / (n * (1.0 + alpha)))
    else:
        restart = np.asarray(personalize, np.float64).ravel() \
            / (n * (1.0 + alpha))
    teleport = np.full(n, alpha * (1.0 + alpha))
    teleport[dangling] += (1.0 - alpha) / (1.0 + alpha)

    # row-stochastic transition, rows scaled in CSR data (dangling rows
    # stay empty — their mass flows through `teleport` instead)
    P = A.multiply(inv_deg[:, None]).tocsr()
    PT = P.T.tocsr()

    pi = restart.copy()
    for _ in range(max_iter):
        nxt = (1.0 - alpha) * (PT @ pi) + float(teleport @ pi) * restart
        done = np.linalg.norm(nxt - pi) <= tol
        pi = nxt
        if done:
            break
    pi = pi / pi.sum()

    scale = np.sqrt(np.maximum(pi, 0.0))
    inv_scale = np.divide(1.0, scale, out=np.zeros_like(scale),
                          where=scale > 0)
    M = P.tocoo(copy=True)
    M.data = M.data * scale[M.row] * inv_scale[M.col]
    M.data[~np.isfinite(M.data)] = 0.0
    L = ((M + M.T) * 0.5).tocsr()
    return L, pi


def cal_fast_appr(alpha: float, edge_index, num_nodes: Optional[int],
                  edge_weight=None) -> Tuple[np.ndarray, np.ndarray]:
    """Fast approximate-PPR graph view (DiGCL)."""
    edge_index = np.asarray(edge_index)
    if num_nodes is None:
        num_nodes = int(edge_index.max()) + 1
    if edge_weight is None:
        edge_weight = np.ones(edge_index.shape[1])
    edge_index, edge_weight = _add_self_loops(edge_index, edge_weight, num_nodes)
    A = sp.csr_matrix((edge_weight, (edge_index[0], edge_index[1])),
                      shape=(num_nodes, num_nodes))
    L, _ = fast_appr_power(A, alpha=alpha, tol=1e-6)
    L = L.tocoo()
    ei = np.stack([L.row, L.col]).astype(np.int64)
    w = _sym_norm(ei, L.data.astype(np.float64), num_nodes)
    return ei, w.astype(np.float32)


def appr_directed_adj(alpha: float, edge_index, num_nodes: Optional[int],
                      edge_weight=None) -> Tuple[np.ndarray, np.ndarray]:
    """Exact PPR stationary-distribution adjacency (DiGCN).

    Dense (N+1)x(N+1) teleport matrix, left eigenvector via scipy
    (O(N^3), as in the original library), pi-weighted symmetrization,
    then sym normalization.
    """
    edge_index = np.asarray(edge_index)
    if num_nodes is None:
        num_nodes = int(edge_index.max()) + 1
    if edge_weight is None:
        edge_weight = np.ones(edge_index.shape[1])
    edge_index, edge_weight = _add_self_loops(edge_index, edge_weight, num_nodes)

    deg = np.zeros(num_nodes)
    deg = deg + np.bincount(edge_index[0], weights=edge_weight,
                            minlength=len(deg))
    deg_inv = np.zeros_like(deg)
    nz = deg > 0
    deg_inv[nz] = 1.0 / deg[nz]
    p = deg_inv[edge_index[0]] * edge_weight

    p_dense = np.zeros((num_nodes, num_nodes))
    np.add.at(p_dense, (edge_index[0], edge_index[1]), p)
    p_v = np.zeros((num_nodes + 1, num_nodes + 1))
    p_v[:num_nodes, :num_nodes] = (1 - alpha) * p_dense
    p_v[num_nodes, :num_nodes] = 1.0 / num_nodes
    p_v[:num_nodes, num_nodes] = alpha

    eig_value, left_vector = scipy.linalg.eig(p_v, left=True, right=False)
    ind = np.argsort(-eig_value.real)
    pi = left_vector[:, ind[0]].real[:num_nodes]
    pi = pi / pi.sum()
    assert (pi < 0).sum() == 0

    pi_sqrt = np.where(pi > 0, np.sqrt(pi), 0.0)
    pi_inv_sqrt = np.where(pi > 0, pi ** -0.5, 0.0)
    L = (pi_sqrt[:, None] * p_dense * pi_inv_sqrt[None, :]
         + pi_inv_sqrt[:, None] * p_dense.T * pi_sqrt[None, :]) / 2.0
    L[np.isnan(L)] = 0

    r, c = np.nonzero(L)
    w = L[r, c]
    ei = np.stack([r, c]).astype(np.int64)
    return ei, _sym_norm(ei, w, num_nodes).astype(np.float32)


def second_directed_adj(edge_index, num_nodes: Optional[int],
                        edge_weight=None) -> Tuple[np.ndarray, np.ndarray]:
    """Second-order proximity adjacency (P^T P ∧ P P^T, DiGCN inception)."""
    edge_index = np.asarray(edge_index)
    if num_nodes is None:
        num_nodes = int(edge_index.max()) + 1
    if edge_weight is None:
        edge_weight = np.ones(edge_index.shape[1])
    edge_index, edge_weight = _add_self_loops(edge_index, edge_weight, num_nodes)

    deg = np.zeros(num_nodes)
    deg = deg + np.bincount(edge_index[0], weights=edge_weight,
                            minlength=len(deg))
    deg_inv = np.zeros_like(deg)
    nz = deg > 0
    deg_inv[nz] = 1.0 / deg[nz]
    p = deg_inv[edge_index[0]] * edge_weight
    p_dense = np.zeros((num_nodes, num_nodes))
    np.add.at(p_dense, (edge_index[0], edge_index[1]), p)

    L_in = p_dense.T @ p_dense
    L_out = p_dense @ p_dense.T
    L_in_hat = L_in.copy()
    L_out_hat = L_out.copy()
    L_in_hat[L_out == 0] = 0
    L_out_hat[L_in == 0] = 0
    L = (L_in_hat + L_out_hat) / 2.0
    L[np.isnan(L)] = 0

    r, c = np.nonzero(L)
    w = L[r, c]
    ei = np.stack([r, c]).astype(np.int64)
    return ei, _sym_norm(ei, w, num_nodes).astype(np.float32)
