"""Directed stochastic block model generator (host-side numpy).

Counterpart of ``pytorch_geometric_signed_directed_tpu/data/dsbm.py``:
vectorized Bernoulli edges per block pair with probability p * F[i, j].
The same ``np.random.Generator`` state gives identical arrays.
"""
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

from .ssbm import geometric_sizes


def _sample_directed_block(u_nodes, v_nodes, p, rng, same_block: bool):
    nu, nv = len(u_nodes), len(v_nodes)
    m = nu * nv
    if m == 0 or p <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    cnt = rng.binomial(m, min(p, 1.0))
    sel = rng.choice(m, cnt, replace=False)
    r, c = u_nodes[sel // nv], v_nodes[sel % nv]
    if same_block:
        keep = r != c  # no self loops
        r, c = r[keep], c[keep]
    return r, c


def DSBM(N: int, K: int, p: float, F: np.ndarray, size_ratio: float = 1,
         rng: Optional[np.random.Generator] = None
         ) -> Tuple[sp.spmatrix, np.ndarray]:
    """Sample a directed SBM: returns (CSR adjacency [N, N], labels [N]).

    Edge (u, v) with u in block i, v in block j appears with probability
    ``p * |F[i, j]|`` and carries the sign of ``F[i, j]``."""
    rng = rng or np.random.default_rng()
    F = np.asarray(F, dtype=float)
    size = geometric_sizes(N, K, size_ratio)
    perm = rng.permutation(N)
    assign = np.zeros(N, dtype=int)
    blocks = []
    start = 0
    for c, s in enumerate(size):
        nodes = perm[start:start + s]
        assign[nodes] = c
        blocks.append(np.asarray(nodes))
        start += s

    rows, cols, vals = [], [], []
    for i in range(K):
        for j in range(K):
            r, c = _sample_directed_block(blocks[i], blocks[j],
                                          p * abs(F[i, j]), rng, i == j)
            if len(r):
                rows.append(r)
                cols.append(c)
                vals.append(np.full(len(r),
                                    -1.0 if F[i, j] < 0 else 1.0))
    if rows:
        A = sp.coo_matrix(
            (np.concatenate(vals), (np.concatenate(rows),
                                    np.concatenate(cols))),
            shape=(N, N)).tocsr()
    else:
        A = sp.csr_matrix((N, N))
    return A, assign
