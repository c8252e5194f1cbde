"""DiGCL helpers: feature dropout and the logistic evaluation of its
embeddings.

Counterpart of ``pytorch_geometric_signed_directed_tpu/utils/directed/
digcl_utils.py``, with the numpy one-vs-rest grid of
``utils/general/logistic.py`` in place of scikit-learn's.  As in the JAX
package, the prediction is ``np.argmax`` over the 0/1 indicator rows the
one-vs-rest probe predicts: a row with no positive label goes to class
0, a tie to the lowest index.
"""
from typing import Optional

import numpy as np
import torch

from ..general.logistic import grid_search_ovr


def drop_feature(x: torch.Tensor, drop_prob: float,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Zero whole feature columns, each with probability ``drop_prob``
    (column-wise ``uniform < drop_prob``), drawn from ``generator`` (a
    fresh one when None) on the generator's device."""
    if generator is None:
        generator = torch.Generator()
        generator.seed()
    mask = torch.rand(x.shape[1], generator=generator,
                      device=generator.device) < drop_prob
    return x.masked_fill(mask.to(x.device)[None, :], 0.0)


def l2_normalize_rows(X: np.ndarray) -> np.ndarray:
    """scikit-learn's ``normalize(X, norm="l2")``: rows over their norm in
    X's own float type, a zero row left as it is."""
    X = np.asarray(X)
    if not np.issubdtype(X.dtype, np.floating):
        X = X.astype(np.float64)
    norms = np.sqrt(np.einsum("ij,ij->i", X, X))
    norms[norms == 0.0] = 1.0
    return X / norms[:, None]


def _onehot(y) -> np.ndarray:
    """[n, K] indicator of y over its sorted distinct values."""
    _, inv = np.unique(np.asarray(y).ravel(), return_inverse=True)
    return np.eye(inv.max() + 1, dtype=bool)[inv]


def pred_digcl_node(embeddings, y, train_index, test_index=None):
    X = l2_normalize_rows(embeddings)
    Y = _onehot(y)
    clf = grid_search_ovr(X[train_index], Y[train_index])
    y_pred = np.argmax(clf.predict(X), axis=1)
    return y_pred if test_index is None else y_pred[test_index]


def pred_digcl_link(embeddings, y, train_index, test_index):
    X = l2_normalize_rows(embeddings)
    Y = _onehot(y)
    train_index = np.asarray(train_index)
    test_index = np.asarray(test_index)
    X_train = np.c_[X[train_index[:, 0]], X[train_index[:, 1]]]
    clf = grid_search_ovr(X_train, Y)
    X_test = np.c_[X[test_index[:, 0]], X[test_index[:, 1]]]
    return np.argmax(clf.predict(X_test), axis=1)
