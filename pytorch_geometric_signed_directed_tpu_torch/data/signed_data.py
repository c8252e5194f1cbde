"""SignedData: container for homogeneous signed graphs (numpy/scipy).

Counterpart of ``pytorch_geometric_signed_directed_tpu/data/
signed_data.py``.
"""
from typing import Tuple, Union

import numpy as np
import scipy.sparse as sp

from ..spectral.features import (signed_laplacian_eig_features,
                                 spectral_adjacency_reg_features)
from ..utils.general.link_split import link_class_split
from .directed_data import GraphData


class SignedData(GraphData):
    def __init__(self, x=None, edge_index=None, edge_attr=None,
                 edge_weight=None, y=None, pos=None,
                 A: Union[Tuple[sp.spmatrix, sp.spmatrix], sp.spmatrix,
                          None] = None,
                 init_data=None, **kwargs):
        if isinstance(A, tuple):
            A = A[0] - A[1]
        super().__init__(x=x, edge_index=edge_index, edge_attr=edge_attr,
                         edge_weight=edge_weight, y=y, pos=pos, A=A,
                         init_data=init_data, **kwargs)

    def separate_positive_negative(self):
        ind = self.edge_weight > 0
        self.edge_index_p = self.edge_index[:, ind]
        self.edge_weight_p = self.edge_weight[ind]
        ind = self.edge_weight < 0
        self.edge_index_n = self.edge_index[:, ind]
        self.edge_weight_n = -self.edge_weight[ind]
        n = self.num_nodes
        self.A_p = sp.coo_matrix(
            (self.edge_weight_p, (self.edge_index_p[0], self.edge_index_p[1])),
            shape=(n, n))
        self.A_n = sp.coo_matrix(
            (self.edge_weight_n, (self.edge_index_n[0], self.edge_index_n[1])),
            shape=(n, n))

    def clear_separate_attributes(self):
        for name in ("edge_index_p", "edge_index_n", "edge_weight_p",
                     "edge_weight_n", "A_p", "A_n"):
            delattr(self, name)

    @property
    def is_signed(self) -> bool:
        return bool(self.edge_weight.max() * self.edge_weight.min() < 0)

    @property
    def is_weighted(self) -> bool:
        self.separate_positive_negative()
        res = (self.edge_weight_p.max() != self.edge_weight_p.min()
               or self.edge_weight_n.max() != self.edge_weight_n.min())
        self.clear_separate_attributes()
        return bool(res)

    def to_unweighted(self):
        self.edge_weight = np.sign(self.edge_weight).astype(np.float32)
        n = self.num_nodes
        self.A = sp.coo_matrix(
            (self.edge_weight, (self.edge_index[0], self.edge_index[1])),
            shape=(n, n))
        if hasattr(self, "edge_weight_p"):
            self.separate_positive_negative()

    def set_signed_Laplacian_features(self, k: int = 2):
        """x = the signed Laplacian's eigenvector features
        (``spectral.features.signed_laplacian_eig_features``)."""
        self.separate_positive_negative()
        self.x = signed_laplacian_eig_features(self.A_p, self.A_n, k)
        self.clear_separate_attributes()

    def set_spectral_adjacency_reg_features(self, k: int = 2,
                                            normalization=None, tau_p=None,
                                            tau_n=None, eigens=None, mi=None):
        """x = the regularized signed adjacency's eigenvector features
        (``spectral.features.spectral_adjacency_reg_features``)."""
        self.separate_positive_negative()
        self.x = spectral_adjacency_reg_features(
            self.A_p, self.A_n, k, normalization, tau_p, tau_n, eigens, mi)
        self.clear_separate_attributes()

    def link_split(self, size=None, splits: int = 2, prob_test: float = 0.15,
                   prob_val: float = 0.05, task: str = "sign", seed: int = 0,
                   ratio: float = 1.0, maintain_connect: bool = False,
                   device=None) -> dict:
        return link_class_split(self, size, splits, prob_test, prob_val,
                                task, seed, maintain_connect, ratio, device)
