"""Class-conditional triplet hinge on inner products (SSSNET's).

Counterpart of ``pytorch_geometric_signed_directed_tpu/utils/general/
triplet_loss.py``: the sampler draws on the host from a numpy generator
(the same values as the JAX package's from the same state), the hinge
runs on the indices it gives.
"""
from typing import Optional

import numpy as np
import torch


def sample_triplets(y: np.ndarray, num_nodes: int, n_sample: int,
                    rng: Optional[np.random.Generator] = None):
    """For each class c, ``n_sample_class = max(n_sample // nclass, 32)``
    draws with replacement of two nodes of c and one of another class;
    returns (same1, same2, different, n_sample_class, nclass), the index
    arrays stacked over classes."""
    rng = rng or np.random.default_rng()
    y = np.asarray(y)
    nclass = int(y.max() - y.min() + 1)
    n_sample_class = max(int(n_sample / nclass), 32)
    nodes = np.arange(num_nodes)
    draws = ([], [], [])
    for c in range(nclass):
        same, other = nodes[y == c], nodes[y != c]
        if len(same) == 0 or len(other) == 0:
            continue
        for out, pool in zip(draws, (same, same, other)):
            out.append(rng.choice(pool, n_sample_class, replace=True))
    return (*(np.concatenate(d) for d in draws), n_sample_class, nclass)


def triplet_loss_inner_product(Z: torch.Tensor, i1, i2, idif,
                               n_sample_class: int, nclass: int,
                               thre: float = 0.1) -> torch.Tensor:
    """Mean over the triplets of max(0, <z1, z_dif - z2> + thre): nodes of
    one class should have inner products larger by ``thre`` than with a
    node of another class."""
    def index(i):
        return torch.as_tensor(i, device=Z.device)

    z1, z2, zd = Z[index(i1)], Z[index(i2)], Z[index(idif)]
    dists = (z1 * (zd - z2)).sum(dim=1) + thre
    loss = torch.where(dists > 0, dists, torch.zeros_like(dists)).sum()
    return loss / (n_sample_class * nclass)


def triplet_loss_node_classification(y, Z: torch.Tensor, n_sample: int,
                                     thre: float,
                                     rng: Optional[np.random.Generator] = None
                                     ) -> torch.Tensor:
    """Sample on the host, then the hinge on ``Z``."""
    i1, i2, idif, n_sample_class, nclass = sample_triplets(
        y, Z.shape[0], n_sample, rng)
    return triplet_loss_inner_product(Z, i1, i2, idif, n_sample_class,
                                      nclass, thre)


class Triplet_Loss_InnerProduct:
    def __init__(self, n_sample: int, thre: float = 0.1):
        self.n_sample = n_sample
        self.thre = thre

    def __call__(self, y, Z):
        return triplet_loss_node_classification(y, Z, self.n_sample,
                                                 self.thre)
