"""Graph reordering for block-sparse execution (host-side scipy).

Counterpart of ``pytorch_geometric_signed_directed_tpu/ops/reorder.py``:
the same arrays for the same input.


Random node orderings spread a sparse graph's edges uniformly over
128x128 blocks, making BSR wasteful; bandwidth- or community-ordered
labelings concentrate them.  Reverse Cuthill-McKee (on the symmetrized
structure) is a cheap, deterministic default that typically cuts the BSR
block count by 3-10x on real graphs.
"""
from typing import Tuple

import numpy as np
import scipy.sparse as sp


def rcm_permutation(row, col, num_nodes: int) -> np.ndarray:
    """perm[new_id] = old_id from reverse Cuthill-McKee on A + A^T."""
    row = np.asarray(row)
    col = np.asarray(col)
    A = sp.coo_matrix((np.ones(len(row)), (row, col)),
                      shape=(num_nodes, num_nodes))
    A = ((A + A.T) > 0).astype(np.int8).tocsr()
    return np.asarray(sp.csgraph.reverse_cuthill_mckee(A, symmetric_mode=True))


def apply_permutation(row, col, perm: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Relabel edges so node old_id -> position of old_id in perm.

    Returns (new_row, new_col, inverse) with inverse[old_id] = new_id; node
    features reorder as x_new = x[perm], outputs map back with
    out_old = out_new[inverse].
    """
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv[np.asarray(row)], inv[np.asarray(col)], inv


def block_density(row, col, num_nodes: int, block: int = 128) -> float:
    """Fraction of touched 128x128 blocks that each edge set occupies —
    lower is better for BSR (1.0 = every edge in its own block)."""
    row = np.asarray(row)
    col = np.asarray(col)
    if len(row) == 0:
        return 0.0
    cb = -(-num_nodes // block)
    nb = len(np.unique((row // block) * cb + (col // block)))
    return nb * block * block / max(len(row), 1)
