"""The largest weakly connected component, then low-degree nodes pruned
(host-side scipy).

Counterpart of ``pytorch_geometric_signed_directed_tpu/utils/general/
extract_network.py``: the same matrix and labels for the same input.
"""
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph  # noqa: F401  (binds sp.csgraph)


def extract_network(A: sp.spmatrix, labels: Optional[np.ndarray] = None,
                    lowest_degree: int = 2, max_iter: int = 10
                    ) -> Tuple[sp.spmatrix, Optional[np.ndarray]]:
    """Keep the largest weakly connected component of ``A``, then drop
    nodes whose unweighted in + out degree is below ``lowest_degree``, up
    to ``max_iter`` rounds (lowering the degree when it would drop every
    node).  Returns the CSR matrix and the labels of the nodes kept."""
    A = A.tocsr()
    n_comp, comp = sp.csgraph.connected_components(A, directed=True,
                                                   connection="weak")
    keep = np.nonzero(comp == np.bincount(comp, minlength=n_comp).argmax())[0]
    A_new = A[keep][:, keep]
    labels = np.asarray(labels)[keep] if labels is not None else None

    for _ in range(max_iter):
        ones = A_new.copy()
        ones.data = np.ones_like(ones.data)
        deg = (np.asarray(ones.sum(0)).ravel()
               + np.asarray(ones.sum(1)).ravel())
        mask = deg >= lowest_degree
        if mask.all():
            break
        if not mask.any():
            lowest_degree -= 1
            print("Nothing to keep, reducing lowest_degree by one to be "
                  f"{lowest_degree}!")
            continue
        A_new = A_new[mask][:, mask]
        if labels is not None:
            labels = labels[mask]
    return A_new, labels
