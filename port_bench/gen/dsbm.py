"""A directed stochastic block model with a meta-graph of block-pair
directions.

Frozen copies of the library's ``DSBM`` sampling and
``meta_graph_generation`` (the ``path`` and ``cyclic`` styles), as
``bench.py``'s ``_build_magnet`` calls them: block pair (i, j) draws
Bernoulli edges with probability ``p * |F[i, j]|``, p = avg_degree / N *
p_factor.  The same ``np.random.default_rng(seed)`` gives the same
graph, E=2,456,932 at seed 0 with N=65,536, 5 blocks, the cyclic
meta-graph at eta 0.05 and p = 30/N x 5/2.  The labels are the blocks.
"""
import math

import numpy as np
import scipy.sparse as sp


def meta_graph(style: str, K: int, eta: float, ambient: bool,
               fill_val: float = 0.5) -> np.ndarray:
    if eta == 0:
        eta = -1
    F = np.eye(K) * 0.5
    if style == "path":
        for i in range(K - 1):
            F[i, i + 1] = 1 - eta
            F[i + 1, i] = 1 - F[i, i + 1]
    elif style == "cyclic":
        if K > 2:
            cyc = K - 1 if ambient else K
            for i in range(cyc):
                j = (i + 1) % cyc
                F[i, j] = 1 - eta
                F[j, i] = 1 - F[i, j]
        elif ambient:
            F = np.full((2, 2), 0.5)
        else:
            F = np.array([[0.5, 1 - eta], [eta, 0.5]])
    else:
        raise ValueError(f"meta-graph style {style!r} has no frozen copy")
    if ambient:
        F[-1, :] = 0
        F[:, -1] = 0
    F[F == 0] = fill_val
    F[F == -1] = 0
    F[F == 2] = 1
    return F


def geometric_sizes(n: int, k: int, size_ratio: float):
    size = [0] * k
    if size_ratio > 1:
        ratio_each = np.power(size_ratio, 1 / (k - 1))
        size[0] = math.floor(n * (1 - ratio_each)
                             / (1 - np.power(ratio_each, k)))
        for i in range(1, k - 1):
            size[i] = math.floor(size[i - 1] * ratio_each)
        size[k - 1] = n - int(np.sum(size[:k - 1]))
    else:
        size = [math.floor((i + 1) * n / k) - math.floor(i * n / k)
                for i in range(k)]
    return size


def _sample_block(u_nodes, v_nodes, p, rng, same_block: bool):
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


def dsbm(N: int, K: int, p: float, F: np.ndarray, size_ratio: float,
         rng: np.random.Generator):
    """(CSR adjacency [N, N] with the sign of F on each edge, blocks [N])."""
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
            r, c = _sample_block(blocks[i], blocks[j], p * abs(F[i, j]), rng,
                                 i == j)
            if len(r):
                rows.append(r)
                cols.append(c)
                vals.append(np.full(len(r), -1.0 if F[i, j] < 0 else 1.0))
    if not rows:
        return sp.csr_matrix((N, N)), assign
    A = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(N, N)).tocsr()
    return A, assign


def generate(traffic: dict, seed: int, device=None) -> dict:
    """The traffic's graph from ``seed``, drawn on the host (``device``
    is not used)."""
    n, k = int(traffic["nodes"]), int(traffic["clusters"])
    F = meta_graph(traffic["meta_graph"], k, float(traffic["eta"]),
                   bool(traffic["ambient"]))
    p = float(traffic["avg_degree"]) / n * float(traffic["p_factor"])
    A, labels = dsbm(n, k, p, F, float(traffic.get("size_ratio", 1)),
                     np.random.default_rng(seed))
    return dict(edge_index=np.vstack(A.nonzero()),
                edge_weight=A.tocoo().data.astype(np.float32), num_nodes=n,
                labels=labels)
