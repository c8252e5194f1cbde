"""Community sizes shared by the SBM generators.

Counterpart of ``pytorch_geometric_signed_directed_tpu/data/ssbm.py``
(``geometric_sizes`` only; the signed generator waits for its slice).
"""
import math

import numpy as np


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
