"""Spectral node features (host side, once per graph).

Counterpart of ``hermitian_features`` in
``pytorch_geometric_signed_directed_tpu/spectral/features.py``, with a
numpy standard scaler in place of scikit-learn's.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg  # noqa: F401  (binds sp.linalg)


def standard_scale(X: np.ndarray) -> np.ndarray:
    """scikit-learn's ``StandardScaler().fit(X).transform(X)``: the mean
    and the population variance (by the corrected two-pass sum) summed in
    float64, columns whose variance is within rounding of zero scaled by
    1, and the transform in X's own float type."""
    X = np.asarray(X)
    n = X.shape[0]
    total = X.sum(axis=0, dtype=np.float64)
    mean = total / n
    centred = X - total / n
    var = ((centred ** 2).sum(axis=0) - centred.sum(axis=0) ** 2 / n) / n
    eps = np.finfo(np.float64).eps
    constant = var <= n * eps * var + (n * mean * eps) ** 2
    scale = np.sqrt(var)
    scale[constant] = 1.0
    return (X - mean.astype(X.dtype)) / scale.astype(X.dtype)


def hermitian_features(A: sp.spmatrix, k: int = 2) -> np.ndarray:
    """[N, 2k] float32: the real and imaginary parts of the k leading left
    singular vectors of the row-normalized Hermitian i (A - A^T), each
    column standardized.

    ``svds`` draws its start vector afresh on every call, so the vectors
    (their phases) differ from call to call; the singular values and the
    projector U U^H do not."""
    H = (A - A.transpose()) * 1j
    H_abs = np.abs(H)
    H_rw = sp.diags(1 / np.array(H_abs.sum(1))[:, 0]).dot(H)
    u, _, _ = sp.linalg.svds(H_rw, k=k)
    feats = np.concatenate((np.real(u), np.imag(u)), axis=1)
    return standard_scale(feats).astype(np.float32)
