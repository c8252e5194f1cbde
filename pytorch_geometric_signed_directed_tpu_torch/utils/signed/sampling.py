"""Host-side edge samplers (numpy) with static output shapes.

Counterpart of ``pytorch_geometric_signed_directed_tpu/utils/signed/
sampling.py``.  Membership tests run on int64 keys ``row * n + col``
(``np.isin``, which takes a lookup table over the key range where that
fits) instead of a Python set; the candidates are drawn from the
generator in the same calls, so the same generator state gives the same
arrays.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _keys(edge_index, num_nodes: int) -> np.ndarray:
    edge_index = np.asarray(edge_index).astype(np.int64)
    return edge_index[0] * num_nodes + edge_index[1]


def negative_sampling(edge_index, num_nodes: int,
                      num_neg_samples: Optional[int] = None,
                      rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Sample [2, M] node pairs that are not edges (PyG negative_sampling)."""
    edge_index = np.asarray(edge_index)
    rng = rng or np.random.default_rng()
    m = num_neg_samples or edge_index.shape[1]
    existing = _keys(edge_index, num_nodes)
    out = np.empty((2, m), dtype=np.int64)
    filled = 0
    while filled < m:
        cand = rng.integers(0, num_nodes, size=(2, 2 * (m - filled) + 8))
        keys = cand[0] * num_nodes + cand[1]
        ok = ~np.isin(keys, existing) & (cand[0] != cand[1])
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
    existing = _keys(edge_index, num_nodes)
    k = rng.integers(0, num_nodes, size=len(i))
    bad = np.isin(i * num_nodes + k, existing)
    while bad.any():
        k[bad] = rng.integers(0, num_nodes, size=int(bad.sum()))
        bad_idx = np.nonzero(bad)[0]
        still = np.isin(i[bad_idx] * num_nodes + k[bad_idx], existing)
        bad[:] = False
        bad[bad_idx[still]] = True
    return i, j, k
