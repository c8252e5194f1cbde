"""Host-side graph helpers (numpy) and the operator builders of the
directed families.

Counterpart of ``pytorch_geometric_signed_directed_tpu/graph.py``: the
same host arrays for the same input.  Everything here runs once, at
preparation time; the builders freeze their operator into a
``Propagator`` (or a fused ``DualPropagator``) on ``device``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

from .device import DeviceLike
from .ops.coalesce import coalesce_edges
from .ops.coo import build_coo
from .ops.spmm import Propagator, dual_propagator, propagator_from_coo


def _as_numpy_graph(edge_index, edge_weight, num_nodes):
    edge_index = np.asarray(edge_index)
    if num_nodes is None:
        num_nodes = int(edge_index.max()) + 1 if edge_index.size else 0
    if edge_weight is None:
        edge_weight = np.ones(edge_index.shape[1], dtype=np.float64)
    else:
        edge_weight = np.asarray(edge_weight, dtype=np.float64)
    return edge_index, edge_weight, int(num_nodes)


def coalesce(edge_index, edge_weight=None, num_nodes: Optional[int] = None):
    """Sort by (row, col) and sum duplicate edges."""
    edge_index, edge_weight, num_nodes = _as_numpy_graph(
        edge_index, edge_weight, num_nodes)
    r, c, w = coalesce_edges(edge_index[0], edge_index[1], edge_weight,
                             num_cols=num_nodes)
    return np.stack([r, c]), w


def to_undirected(edge_index, edge_weight=None,
                  num_nodes: Optional[int] = None):
    """Symmetrize the edge set (duplicate weights coalesced by sum)."""
    edge_index, edge_weight, num_nodes = _as_numpy_graph(
        edge_index, edge_weight, num_nodes)
    row = np.concatenate([edge_index[0], edge_index[1]])
    col = np.concatenate([edge_index[1], edge_index[0]])
    w = np.concatenate([edge_weight, edge_weight])
    return coalesce(np.stack([row, col]), w, num_nodes)


def add_remaining_self_loops(edge_index, edge_weight, num_nodes,
                             fill_value=1.0):
    """Append a loop of weight ``fill_value`` at every node without one."""
    has_loop = np.zeros(num_nodes, dtype=bool)
    loop_mask = edge_index[0] == edge_index[1]
    has_loop[edge_index[0][loop_mask]] = True
    missing = np.nonzero(~has_loop)[0]
    row = np.concatenate([edge_index[0], missing])
    col = np.concatenate([edge_index[1], missing])
    w = np.concatenate([edge_weight, np.full(len(missing), fill_value)])
    return np.stack([row, col]), w


def gcn_norm(edge_index, edge_weight=None, num_nodes: Optional[int] = None,
             improved: bool = False, add_self_loops: bool = True):
    """GCN normalization D^-1/2 (A + fI) D^-1/2, f = 1 or 2 (``improved``),
    with the degree taken at the target ``edge_index[1]``."""
    edge_index, edge_weight, num_nodes = _as_numpy_graph(
        edge_index, edge_weight, num_nodes)
    fill = 2.0 if improved else 1.0
    if add_self_loops:
        edge_index, edge_weight = add_remaining_self_loops(
            edge_index, edge_weight, num_nodes, fill)
    deg = np.zeros(num_nodes)
    deg = deg + np.bincount(edge_index[1], weights=edge_weight,
                            minlength=len(deg))
    dinv = np.zeros_like(deg)
    nz = deg > 0
    dinv[nz] = deg[nz] ** -0.5
    norm = dinv[edge_index[0]] * edge_weight * dinv[edge_index[1]]
    return edge_index, norm


def gcn_norm_propagator(edge_index, edge_weight=None,
                        num_nodes: Optional[int] = None,
                        improved: bool = False, add_self_loops: bool = True,
                        mode: str = "auto",
                        device: DeviceLike = None) -> Propagator:
    """The GCN-normalized operator aggregating at the target node
    (``out[t] += norm * x[s]``), duplicates summed: DGCN's convolution."""
    edge_index, edge_weight, num_nodes = _as_numpy_graph(
        edge_index, edge_weight, num_nodes)
    ei, norm = gcn_norm(edge_index, edge_weight, num_nodes, improved,
                        add_self_loops)
    A = build_coo(ei[1], ei[0], norm, num_nodes, sum_duplicates=True,
                  device=device)
    return propagator_from_coo(A, mode=mode)


def norm_propagator(edge_index, edge_weight, num_nodes: Optional[int] = None,
                    flow: str = "source_to_target", mode: str = "auto",
                    device: DeviceLike = None) -> Propagator:
    """A precomputed normalized adjacency (DiGCN's PPR adjacency, DIGRAC's
    raw A) as a Propagator, duplicates summed.  ``source_to_target``
    aggregates at ``edge_index[1]``, ``target_to_source`` at
    ``edge_index[0]``."""
    edge_index, edge_weight, num_nodes = _as_numpy_graph(
        edge_index, edge_weight, num_nodes)
    if flow == "source_to_target":
        row, col = edge_index[1], edge_index[0]
    else:
        row, col = edge_index[0], edge_index[1]
    A = build_coo(row, col, edge_weight, num_nodes, sum_duplicates=True,
                  device=device)
    return propagator_from_coo(A, mode=mode)


def _rw_norm(edge_index, edge_weight, num_nodes, fill_value,
             add_self_loops=True):
    """D^-1 (A + fill I) by out-degree (``edge_index[0]``): the edges with
    their loops and the normalized weights."""
    if add_self_loops:
        edge_index, edge_weight = add_remaining_self_loops(
            edge_index, edge_weight, num_nodes, fill_value)
    deg = np.zeros(num_nodes)
    deg = deg + np.bincount(edge_index[0], weights=edge_weight,
                            minlength=len(deg))
    dinv = np.zeros_like(deg)
    nz = deg > 0
    dinv[nz] = 1.0 / deg[nz]
    return edge_index, dinv[edge_index[0]] * edge_weight


def rw_norm_propagator(edge_index, edge_weight=None,
                       num_nodes: Optional[int] = None,
                       fill_value: float = 0.5, add_self_loops: bool = True,
                       mode: str = "auto",
                       device: DeviceLike = None) -> Propagator:
    """Row-normalized D^-1 (A + fill I) aggregating at the source node:
    the walk operator of DIMPA (``Conv_Base``)."""
    edge_index, edge_weight, num_nodes = _as_numpy_graph(
        edge_index, edge_weight, num_nodes)
    edge_index, norm = _rw_norm(edge_index, edge_weight, num_nodes,
                                fill_value, add_self_loops)
    A = build_coo(edge_index[0], edge_index[1], norm, num_nodes,
                  sum_duplicates=True, device=device)
    return propagator_from_coo(A, mode=mode)


def rw_norm_dual_propagator(edge_index, edge_weight=None,
                            num_nodes: Optional[int] = None,
                            fill_value: float = 0.5, mode: str = "mxu",
                            device: DeviceLike = None):
    """DIMPA's two walk operators, P_s = rw_norm(A) and P_t = rw_norm(A^T),
    fused into one operator over the union of both edge directions
    (``val_a`` the forward normalization, 0 on reverse entries; ``val_b``
    the other way), so ``[P_s x_s | P_t x_t]`` is one apply.  None on the
    dense tier, where fusing buys nothing."""
    edge_index, edge_weight, num_nodes = _as_numpy_graph(
        edge_index, edge_weight, num_nodes)
    ei_s, norm_s = _rw_norm(edge_index, edge_weight, num_nodes, fill_value)
    ei_t, norm_t = _rw_norm(edge_index[[1, 0]], edge_weight, num_nodes,
                            fill_value)
    row = np.concatenate([ei_s[0], ei_t[0]])
    col = np.concatenate([ei_s[1], ei_t[1]])
    va = np.concatenate([norm_s, np.zeros(len(norm_t))])
    vb = np.concatenate([np.zeros(len(norm_s)), norm_t])
    return dual_propagator(row, col, va, vb, num_nodes=num_nodes, mode=mode,
                           device=device)


def adj_dual_propagator(edge_index, edge_weight=None,
                        num_nodes: Optional[int] = None, mode: str = "mxu",
                        device: DeviceLike = None):
    """A and A^T fused into one union-edge-set operator: one apply gives
    ``[A x_a | A^T x_b]``.  Prob_Imbalance_Loss takes it in place of the
    (P_A, P_AT) pair; duplicate edges sum, as in the pair."""
    edge_index, edge_weight, num_nodes = _as_numpy_graph(
        edge_index, edge_weight, num_nodes)
    e = len(edge_weight)
    row = np.concatenate([edge_index[0], edge_index[1]])
    col = np.concatenate([edge_index[1], edge_index[0]])
    va = np.concatenate([edge_weight, np.zeros(e)])
    vb = np.concatenate([np.zeros(e), edge_weight])
    return dual_propagator(row, col, va, vb, num_nodes=num_nodes, mode=mode,
                           device=device)


def mean_propagator(edge_index, num_nodes: Optional[int] = None,
                    flow: str = "source_to_target", mode: str = "auto",
                    device: DeviceLike = None) -> Propagator:
    """Unweighted mean aggregation, SGCNConv's: with ``source_to_target``
    ``out[t] = mean of x[s]`` over the edges (s, t) (over (t, s) with
    ``target_to_source``); a node without such edges gets 0.  Duplicate
    edges stay separate entries and count separately."""
    edge_index, _, num_nodes = _as_numpy_graph(edge_index, None, num_nodes)
    if flow == "source_to_target":
        row, col = edge_index[1], edge_index[0]
    else:
        row, col = edge_index[0], edge_index[1]
    cnt = np.bincount(row, minlength=num_nodes).astype(np.float64)
    cnt[cnt == 0] = 1.0
    A = build_coo(row, col, 1.0 / cnt[row], num_nodes, device=device)
    return propagator_from_coo(A, mode=mode)


def directed_features_in_out(edge_index, size: int, edge_weight=None):
    """DGCN's second-order in and out proximity graphs,
    A_in = A^T D_c^-1 A and A_out = A D_r^-1 A^T (column and row sums of A,
    zeros taken as 1), as two sparse products.

    Returns (index_undirected, edge_in, in_weight, edge_out, out_weight)."""
    edge_index, edge_weight, size = _as_numpy_graph(edge_index, edge_weight,
                                                    size)
    a = sp.coo_matrix((edge_weight, (edge_index[0], edge_index[1])),
                      shape=(size, size)).tocsr()
    out_degree = np.asarray(a.sum(axis=0)).ravel()
    out_degree[out_degree == 0] = 1
    in_degree = np.asarray(a.sum(axis=1)).ravel()
    in_degree[in_degree == 0] = 1

    A_in = (a.T @ sp.diags(1.0 / out_degree) @ a).tocoo()
    A_out = (a @ sp.diags(1.0 / in_degree) @ a.T).tocoo()

    edge_in = np.vstack([A_in.row, A_in.col]).astype(np.int64)
    edge_out = np.vstack([A_out.row, A_out.col]).astype(np.int64)
    index_undirected, _ = to_undirected(edge_index, None, size)
    return (index_undirected, edge_in, A_in.data.astype(np.float32),
            edge_out, A_out.data.astype(np.float32))


def in_out_degree(edge_index, size: Optional[int] = None, signed: bool = False,
                  edge_weight=None) -> np.ndarray:
    """(in, out) degree features [N, 2] float32; signed graphs get 4
    columns (in+, in-, out+, out-).

    As in the original library, "in" is the row sum of
    A[edge_index[0], edge_index[1]] and "out" the column sum."""
    edge_index, edge_weight, size = _as_numpy_graph(edge_index, edge_weight, size)
    if signed:
        A = sp.coo_matrix((edge_weight, (edge_index[0], edge_index[1])),
                          shape=(size, size)).tocsr()
        A_abs = A.copy()
        A_abs.data = np.abs(A_abs.data)
        A_p = (A_abs + A) / 2
        A_n = (A_abs - A) / 2
        out_pos = np.asarray(A_p.sum(axis=0)).ravel()
        out_neg = np.asarray(A_n.sum(axis=0)).ravel()
        in_pos = np.asarray(A_p.sum(axis=1)).ravel()
        in_neg = np.asarray(A_n.sum(axis=1)).ravel()
        return np.stack([in_pos, in_neg, out_pos, out_neg], axis=1).astype(np.float32)
    w = np.abs(edge_weight)
    in_deg = np.zeros(size)
    out_deg = np.zeros(size)
    in_deg = in_deg + np.bincount(edge_index[0], weights=w,
                                  minlength=len(in_deg))
    out_deg = out_deg + np.bincount(edge_index[1], weights=w,
                                    minlength=len(out_deg))
    return np.stack([in_deg, out_deg], axis=1).astype(np.float32)
