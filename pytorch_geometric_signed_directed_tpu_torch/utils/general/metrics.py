"""Clustering scores in numpy (the card's machine has no scikit-learn)."""
import numpy as np


def adjusted_rand_score(labels_true, labels_pred) -> float:
    """The adjusted Rand index, by scikit-learn's pair-confusion formula:
    1.0 where the two labelings agree on every pair (no data, one cluster
    each, or every point alone in both)."""
    labels_true = np.asarray(labels_true).ravel()
    labels_pred = np.asarray(labels_pred).ravel()
    if labels_true.shape != labels_pred.shape:
        raise ValueError(f"labelings of {labels_true.shape} and "
                         f"{labels_pred.shape} samples")
    n = labels_true.shape[0]
    _, t = np.unique(labels_true, return_inverse=True)
    _, p = np.unique(labels_pred, return_inverse=True)
    # the contingency table's nonzero cells, and the class and cluster sizes
    _, cells = np.unique(t.astype(np.int64) * (int(p.max(initial=0)) + 1)
                         + p, return_counts=True)
    n_c = np.bincount(t).astype(np.int64)
    n_k = np.bincount(p).astype(np.int64)
    sum_squares = int((cells.astype(np.int64) ** 2).sum())
    tp = sum_squares - n
    fp = int((n_k ** 2).sum()) - sum_squares
    fn = int((n_c ** 2).sum()) - sum_squares
    tn = n * n - fp - fn - sum_squares
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn)
                                        + (tp + fp) * (fp + tn))
