"""Logistic-regression evaluation of frozen embeddings on edges.

Counterpart of ``pytorch_geometric_signed_directed_tpu/utils/general/
evaluation.py``, on the numpy probe of ``logistic.py`` in place of
scikit-learn: an edge's features are its two end embeddings side by side.
Runs on the host, once per evaluation.
"""
from typing import Tuple, Union

import numpy as np

from .logistic import LogisticRegression, accuracy_score, f1_score, \
    roc_auc_score


def _edge_features(embeddings, pairs) -> np.ndarray:
    pairs = np.asarray(pairs)
    return np.concatenate(
        [embeddings[pairs[:, 0]], embeddings[pairs[:, 1]]], axis=1)


def _fit(embeddings, train_X, train_y, class_weight) -> LogisticRegression:
    return LogisticRegression(class_weight=class_weight).fit(
        _edge_features(np.asarray(embeddings), train_X), np.asarray(train_y))


def link_sign_prediction_logistic_function(
    embeddings: np.ndarray, train_X, train_y, test_X, test_y,
    class_weight: Union[dict, str, None] = None,
) -> Tuple[float, float, float, float, float]:
    """Returns (accuracy, binary-F1, macro-F1, micro-F1, AUC)."""
    clf = _fit(embeddings, train_X, train_y, class_weight)
    test_feats = _edge_features(np.asarray(embeddings), test_X)
    pred = clf.predict(test_feats)
    pred_p = clf.predict_proba(test_feats)
    test_y = np.asarray(test_y)
    return (accuracy_score(test_y, pred), f1_score(test_y, pred),
            f1_score(test_y, pred, average="macro"),
            f1_score(test_y, pred, average="micro"),
            roc_auc_score(test_y, pred_p[:, 1]))


def link_sign_direction_prediction_logistic_function(
    embeddings: np.ndarray, train_X, train_y, test_X, test_y,
    class_weight: Union[dict, str, None] = None,
) -> Tuple[float, float, float]:
    """Multi-class variant; returns (accuracy, macro-F1, micro-F1)."""
    clf = _fit(embeddings, train_X, train_y, class_weight)
    pred = clf.predict(_edge_features(np.asarray(embeddings), test_X))
    test_y = np.asarray(test_y)
    return (accuracy_score(test_y, pred),
            f1_score(test_y, pred, average="macro"),
            f1_score(test_y, pred, average="micro"))
