"""Signed stochastic block model generator (host-side numpy).

Counterpart of ``pytorch_geometric_signed_directed_tpu/data/ssbm.py``:
Bernoulli edges per block pair (a binomial count, then that many distinct
pairs drawn by ``choice``), signs flipped with probability eta, and
community sizes in geometric progression.  The same
``np.random.Generator`` state gives identical arrays.
"""
import math
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp


def fill(values: str = "ones", size: int = 1,
         rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Edge weights: ones, or exponential / uniform draws from ``rng``."""
    rng = rng or np.random.default_rng()
    if values == "ones":
        return np.ones(size)
    if values == "exp":
        return rng.exponential(size=size)
    if values == "uniform":
        return rng.uniform(size=size)
    raise ValueError(values)


def geometric_sizes(n: int, k: int, size_ratio: float):
    """Community sizes in geometric progression (equal split when
    ``size_ratio <= 1``)."""
    size = [0] * k
    if size_ratio > 1:
        ratio_each = np.power(size_ratio, 1 / (k - 1))
        size[0] = math.floor(n * (1 - ratio_each) / (1 - np.power(ratio_each, k)))
        for i in range(1, k - 1):
            size[i] = math.floor(size[i - 1] * ratio_each)
        size[k - 1] = n - int(np.sum(size[:k - 1]))
    else:
        size = [math.floor((i + 1) * n / k) - math.floor(i * n / k)
                for i in range(k)]
    return size


def _upper_pairs(sel: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Entries ``sel`` of ``np.triu_indices(n, k=1)`` without building it:
    row i holds the linear indices [start_i, start_i + n - 1 - i)."""
    i = np.arange(n, dtype=np.int64)
    start = i * (n - 1) - i * (i - 1) // 2
    r = np.searchsorted(start, sel, side="right") - 1
    return r, sel - start[r] + r + 1


def _sample_pairs(u_nodes, v_nodes, p, rng, same_block: bool):
    """Bernoulli(p) unordered pairs between two node sets (within one set:
    the pairs i < j).

    The generator's ``choice`` of ``cnt`` of ``m`` pairs holds an int64
    table of all m (8 bytes a pair); the pairs themselves are decoded from
    the chosen indices, so nothing else of size m is built.  At N=65,536
    and K=3 the largest block pair has 5.7e8 pairs (size ratio 1.5) to
    6.2e8 (ratio 2), so a call peaks near 5 GB."""
    nu, nv = len(u_nodes), len(v_nodes)
    m = nu * (nu - 1) // 2 if same_block else nu * nv
    if m == 0 or p <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    cnt = rng.binomial(m, min(p, 1.0))
    sel = rng.choice(m, cnt, replace=False)
    if same_block:
        iu, iv = _upper_pairs(sel, nu)
        return u_nodes[iu], v_nodes[iv]
    return u_nodes[sel // nv], v_nodes[sel % nv]


def SSBM(n: int, k: int, pin: float, etain: float,
         pout: Optional[float] = None, size_ratio: float = 2,
         etaout: Optional[float] = None, values: str = "ones",
         rng: Optional[np.random.Generator] = None
         ) -> Tuple[Tuple[sp.spmatrix, sp.spmatrix], np.ndarray]:
    """((A_p, A_n), labels): symmetric CSC adjacencies of the positive and
    negative edges and each node's community.  Within a community a pair is
    an edge with probability ``pin`` and negative with probability
    ``etain``; between communities with ``pout``, and positive with
    ``etaout``."""
    rng = rng or np.random.default_rng()
    pout = pin if pout is None else pout
    etaout = etain if etaout is None else etaout

    size = geometric_sizes(n, k, size_ratio)
    perm = rng.permutation(n)
    assign = np.zeros(n, dtype=int)
    blocks = []
    start = 0
    for c, s in enumerate(size):
        nodes = perm[start:start + s]
        assign[nodes] = c
        blocks.append(np.asarray(nodes))
        start += s

    parts = {True: ([], [], []), False: ([], [], [])}   # positive, negative

    def add(u, v, flip_p, within: bool):
        """Both directions of pairs (u, v); a pair is flipped (negative
        within a community, positive between two) with probability
        ``flip_p``."""
        if len(u) == 0:
            return
        w = fill(values, len(u), rng)
        flipped = rng.random(len(u)) < flip_p
        positive = ~flipped if within else flipped
        for sign, mask in ((True, positive), (False, ~positive)):
            rows, cols, vals = parts[sign]
            uu, vv, ww = u[mask], v[mask], w[mask]
            rows.extend([uu, vv])
            cols.extend([vv, uu])
            vals.extend([ww, ww])

    for i in range(k):
        u, v = _sample_pairs(blocks[i], blocks[i], pin, rng, same_block=True)
        add(u, v, etain, within=True)
        for j in range(i + 1, k):
            u, v = _sample_pairs(blocks[i], blocks[j], pout, rng,
                                 same_block=False)
            add(u, v, etaout, within=False)

    def build(rows, cols, vals):
        if not rows:
            return sp.csc_matrix((n, n))
        return sp.coo_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=(n, n)).tocsc()

    return (build(*parts[True]), build(*parts[False])), assign
