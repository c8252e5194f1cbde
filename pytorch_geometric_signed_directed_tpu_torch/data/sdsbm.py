"""Signed directed stochastic block model generator (host-side numpy).

Counterpart of ``pytorch_geometric_signed_directed_tpu/data/sdsbm.py``:
DSBM on |F| with the blocks where F < 0 negated, then an ``eta`` fraction
of the edge signs flipped.  The same generator state gives the same
arrays.
"""
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

from .dsbm import _dsbm_core


def SDSBM(N: int, K: int, p: float, F: np.ndarray, size_ratio: float = 1,
          eta: float = 0.1, rng: Optional[np.random.Generator] = None
          ) -> Tuple[sp.spmatrix, np.ndarray]:
    """Sample a signed directed SBM: returns (CSR adjacency [N, N] with
    entries +-1, labels [N])."""
    rng = rng or np.random.default_rng()
    A, assign = _dsbm_core(N, K, p, np.asarray(F, dtype=float), size_ratio,
                           rng)
    A = A.tocsr()
    if len(A.data):
        flip = rng.choice(len(A.data), size=int(len(A.data) * eta),
                          replace=False)
        A.data[flip] *= -1
    return A, assign
