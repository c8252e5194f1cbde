"""Meta-graph adjacency generation for DSBM experiments (host-side numpy).

Counterpart of ``pytorch_geometric_signed_directed_tpu/utils/directed/
meta_graph.py``.
"""
import math

import numpy as np


def meta_graph_generation(F_style: str = "cyclic", K: int = 4,
                          eta: float = 0.05, ambient: bool = False,
                          fill_val: float = 0.5) -> np.ndarray:
    """[K, K] block-pair edge-direction probabilities for a DSBM.

    ``F_style`` is one of 'path', 'cyclic', 'complete', 'star' and
    'multipartite'; 'complete' draws its directions from numpy's global
    random state."""
    if eta == 0:
        eta = -1
    F = np.eye(K) * 0.5
    if F_style == "path":
        for i in range(K - 1):
            F[i, i + 1] = 1 - eta
            F[i + 1, i] = 1 - F[i, i + 1]
    elif F_style == "cyclic":
        if K > 2:
            cyc = K - 1 if ambient else K
            for i in range(cyc):
                j = (i + 1) % cyc
                F[i, j] = 1 - eta
                F[j, i] = 1 - F[i, j]
        else:
            if ambient:
                F = np.full((2, 2), 0.5)
            else:
                F = np.array([[0.5, 1 - eta], [eta, 0.5]])
    elif F_style == "complete":
        if K > 2:
            for i in range(K - 1):
                for j in range(i + 1, K):
                    direction = np.random.randint(2)
                    F[i, j] = direction * (1 - eta) + (1 - direction) * eta
                    F[j, i] = 1 - F[i, j]
        else:
            F = np.array([[0.5, 1 - eta], [eta, 0.5]])
    elif F_style == "star":
        if K < 3:
            raise ValueError("star shape requires K at least 3")
        if ambient and K < 4:
            raise ValueError(
                "star shape with ambient nodes requires K at least 4")
        center = math.floor((K - 1) / 2)
        F[center, ::2] = eta
        F[center, 1::2] = 1 - eta
        F[::2, center] = 1 - eta
        F[1::2, center] = eta
    elif F_style == "multipartite":
        if K < 3:
            raise ValueError("multipartite shape requires K at least 3")
        if ambient:
            if K < 4:
                raise ValueError(
                    "multipartite shape with ambient nodes requires K at "
                    "least 4")
            g1 = math.ceil((K - 1) / 9)
            g2 = math.ceil((K - 1) * 3 / 9) + g1
        else:
            g1 = math.ceil(K / 9)
            g2 = math.ceil(K * 3 / 9) + g1
        F[:g1, g1:g2] = eta
        F[g1:g2, g2:] = eta
        F[g2:, g1:g2] = 1 - eta
        F[g1:g2, :g1] = 1 - eta
    else:
        raise ValueError(f"unknown F style {F_style!r}")
    if ambient:
        F[-1, :] = 0
        F[:, -1] = 0
    F[F == 0] = fill_val
    F[F == -1] = 0
    F[F == 2] = 1
    return F
