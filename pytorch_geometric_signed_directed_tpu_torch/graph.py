"""Host-side graph helpers (numpy).

Counterpart of ``pytorch_geometric_signed_directed_tpu/graph.py``; only
the pieces of the MagNet path so far.  The operator builders of the other
model families come with their slices.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp


def _as_numpy_graph(edge_index, edge_weight, num_nodes):
    edge_index = np.asarray(edge_index)
    if num_nodes is None:
        num_nodes = int(edge_index.max()) + 1 if edge_index.size else 0
    if edge_weight is None:
        edge_weight = np.ones(edge_index.shape[1], dtype=np.float64)
    else:
        edge_weight = np.asarray(edge_weight, dtype=np.float64)
    return edge_index, edge_weight, int(num_nodes)


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
