"""Host-side edge samplers (numpy) with static output shapes.

Counterpart of ``pytorch_geometric_signed_directed_tpu/utils/signed/
sampling.py``.  Membership tests run on int64 keys ``row * n + col``, by a
binary search of the sorted edge keys, instead of a Python set; the
candidates are drawn from the generator in the same calls, so the same
generator state gives the same arrays.  (Not ``np.isin``: numpy >= 2.3
answers it through a hashed ``np.unique``.  SGCN's three samplers at 720k
edges took 1.9 s a set with it on an H100 machine's host, numpy 2.3.5;
0.27-0.30 s there with the sorted search.)
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ...ops.coalesce import sorted_unique


def _keys(edge_index, num_nodes: int) -> np.ndarray:
    edge_index = np.asarray(edge_index).astype(np.int64)
    return edge_index[0] * num_nodes + edge_index[1]


def _member(keys: np.ndarray, table: np.ndarray) -> np.ndarray:
    """keys[i] in ``table`` (sorted, unique) for each i: the keys sorted,
    so that the binary searches walk the table in order."""
    found = np.zeros(len(keys), bool)
    if len(table) == 0 or len(keys) == 0:
        return found
    order = np.argsort(keys)
    sk = keys[order]
    at = np.minimum(np.searchsorted(table, sk), len(table) - 1)
    found[order] = table[at] == sk
    return found


def negative_sampling(edge_index, num_nodes: int,
                      num_neg_samples: Optional[int] = None,
                      rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Sample [2, M] node pairs that are not edges (PyG negative_sampling)."""
    edge_index = np.asarray(edge_index)
    rng = rng or np.random.default_rng()
    m = num_neg_samples or edge_index.shape[1]
    existing = sorted_unique(_keys(edge_index, num_nodes))
    out = np.empty((2, m), dtype=np.int64)
    filled = 0
    while filled < m:
        cand = rng.integers(0, num_nodes, size=(2, 2 * (m - filled) + 8))
        keys = cand[0] * num_nodes + cand[1]
        ok = ~_member(keys, existing) & (cand[0] != cand[1])
        take = min(int(ok.sum()), m - filled)
        out[:, filled:filled + take] = cand[:, np.nonzero(ok)[0][:take]]
        filled += take
    return out


def structured_negative_sampling(
    edge_index, num_nodes: int,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """For each edge (i, j) sample k with (i, k) not an edge; returns (i, j, k)."""
    edge_index = np.asarray(edge_index).astype(np.int64)
    rng = rng or np.random.default_rng()
    i, j = edge_index[0], edge_index[1]
    existing = sorted_unique(_keys(edge_index, num_nodes))
    k = rng.integers(0, num_nodes, size=len(i))
    bad = _member(i * num_nodes + k, existing)
    while bad.any():
        k[bad] = rng.integers(0, num_nodes, size=int(bad.sum()))
        bad_idx = np.nonzero(bad)[0]
        still = _member(i[bad_idx] * num_nodes + k[bad_idx], existing)
        bad[:] = False
        bad[bad_idx[still]] = True
    return i, j, k
