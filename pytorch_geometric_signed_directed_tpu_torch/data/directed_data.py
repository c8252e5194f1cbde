"""DirectedData: container for homogeneous directed graphs (numpy/scipy).

Counterpart of ``pytorch_geometric_signed_directed_tpu/data/
directed_data.py``.  The arrays stay on the host; the experiments build
the operators on the card from them.  ``GraphData`` holds what
``DirectedData`` and ``SignedData`` share.
"""
from typing import Optional

import numpy as np
import scipy.sparse as sp

from ..spectral.features import hermitian_features
from ..utils.general.link_split import link_class_split
from ..utils.general.node_split import node_class_split


class GraphData:
    """The adjacency ``A`` (COO) with its ``edge_index``/``edge_weight``,
    extra attributes, and the node and link splits."""

    def __init__(self, x=None, edge_index=None, edge_attr=None,
                 edge_weight=None, y=None, pos=None,
                 A: Optional[sp.spmatrix] = None, init_data=None, **kwargs):
        self.x = np.asarray(x) if x is not None else None
        self.y = np.asarray(y) if y is not None else None
        self.edge_attr = edge_attr
        self.pos = pos
        for k, v in kwargs.items():
            setattr(self, k, v)
        if A is None:
            edge_index = np.asarray(edge_index)
            n = int(edge_index.max()) + 1 if edge_index.size else 0
            if edge_weight is None:
                edge_weight = np.ones(edge_index.shape[1], np.float32)
            A = sp.coo_matrix((np.asarray(edge_weight),
                               (edge_index[0], edge_index[1])), shape=(n, n))
        self.A = A.tocoo()
        self.edge_weight = np.asarray(self.A.data, np.float32)
        self.edge_index = np.asarray(self.A.nonzero(), np.int64)
        self.num_nodes = self.A.shape[0]
        if init_data is not None:
            self.inherit_attributes(init_data)

    @property
    def is_directed(self) -> bool:
        A = self.A.tocsr()
        return (A != A.T).nnz > 0

    def inherit_attributes(self, data):
        src = data.__dict__ if not isinstance(data, dict) else data
        for k, v in src.items():
            if not hasattr(self, k) or getattr(self, k) is None:
                setattr(self, k, v)

    def node_split(self, train_size=None, val_size=None, test_size=None,
                   seed_size=None, train_size_per_class=None,
                   val_size_per_class=None, test_size_per_class=None,
                   seed_size_per_class=None, seed=None, data_split: int = 2):
        node_class_split(
            self, train_size=train_size, val_size=val_size,
            test_size=test_size, seed_size=seed_size,
            train_size_per_class=train_size_per_class,
            val_size_per_class=val_size_per_class,
            test_size_per_class=test_size_per_class,
            seed_size_per_class=seed_size_per_class, seed=seed,
            data_split=data_split)


class DirectedData(GraphData):
    @property
    def is_weighted(self) -> bool:
        return bool(self.edge_weight.max() != self.edge_weight.min())

    def to_unweighted(self):
        n = self.num_nodes
        self.A = sp.coo_matrix(
            (np.ones(self.edge_index.shape[1], np.float32),
             (self.edge_index[0], self.edge_index[1])), shape=(n, n))
        self.edge_weight = np.asarray(self.A.data, np.float32)

    def set_hermitian_features(self, k: int = 2):
        self.x = hermitian_features(self.A.tocsr(), k)

    def link_split(self, size=None, splits: int = 2, prob_test: float = 0.15,
                   prob_val: float = 0.05, task: str = "direction",
                   seed: int = 0, ratio: float = 1.0,
                   maintain_connect: bool = True, device=None) -> dict:
        if task == "sign":
            raise ValueError("If you would like to solve a link sign "
                             "prediction task, use SignedData class "
                             "instead!")
        return link_class_split(self, size, splits, prob_test, prob_val,
                                task, seed, maintain_connect, ratio, device)
