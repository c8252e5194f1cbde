"""Spectral node features (once per graph).

Counterpart of ``pytorch_geometric_signed_directed_tpu/spectral/
features.py``, without scikit-learn (the card's machine has none): a numpy
standard scaler and a numpy randomized SVD in place of its
``StandardScaler`` and ``TruncatedSVD``.  Given a CUDA ``device``, the
randomized SVD's power iterations run there in float64 (torch sparse
products and LU factorizations) from the same host-drawn start.

``eigs`` and ``svds`` draw a random start vector on every call unless
given one, so the signed and Hermitian features differ from call to call
(in both packages); their eigenvalues and the spans of their vectors do
not.
"""
from __future__ import annotations

import contextlib
import warnings
from typing import Optional

import numpy as np
import scipy.linalg
import scipy.sparse as sp
import scipy.sparse.linalg  # noqa: F401  (binds sp.linalg)
import torch

from ..device import DeviceLike
from ..instrument import span
from ..ops.coalesce import sorted_unique


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


def _inv_sqrt(d: np.ndarray) -> np.ndarray:
    """1 / sqrt(d), with the square root floored at 1/999999999."""
    return 1.0 / np.maximum(np.sqrt(d), 1 / 999999999)


def _column_sums(M: sp.spmatrix) -> np.ndarray:
    """Column sums in M's own float type (scipy's), as float64."""
    return np.asarray(M.sum(axis=0), dtype=np.float64).ravel()


def signed_laplacian_eig_features(A_p: sp.spmatrix, A_n: sp.spmatrix,
                                  k: int = 2) -> np.ndarray:
    """[N, k] float32: the k eigenvectors of largest real part of the
    normalized signed Laplacian I - D^-1/2 (A_p - A_n) D^-1/2, with D the
    column sums of A_p + A_n, each divided by its eigenvalue."""
    n = A_p.shape[0]
    d = _inv_sqrt(_column_sums(A_p) + _column_sums(A_n))
    S = sp.diags(d).tocsc()
    L = sp.eye(n, format="csc") - S * (A_p - A_n).tocsc() * S
    vals, vecs = sp.linalg.eigs(L, int(k), maxiter=n, which="LR")
    return np.real(vecs / vals).astype(np.float32)


def spectral_adjacency_reg_features(
    A_p: sp.spmatrix,
    A_n: sp.spmatrix,
    k: int = 2,
    normalization: Optional[str] = None,
    tau_p=None,
    tau_n=None,
    eigens=None,
    mi=None,
) -> np.ndarray:
    """[N, eigens] float32 (``eigens`` defaults to k): the eigenvectors of
    largest real part of the tau-regularized signed adjacency, each scaled
    by its eigenvalue (ARPACK ``which="LR"``, at most ``mi`` iterations,
    default N), as SSSNET's input features.

    The regularized adjacency adds tau_p to every entry of A_p and tau_n to
    every entry of A_n (tau defaults to a quarter of the mean nonzero
    degree over N), so A_tau = A_p - A_n + (tau_p - tau_n) 1 1^T is applied
    matrix-free.  ``normalization``:

      * None:      A_tau.
      * "sym":     D^-1/2 A_tau D^-1/2.  D is the column sums of A_p + A_n
                   in float32 with tau added to their stored entries only,
                   plus (N - Dbar) |tau_p - tau_n| for the entries off the
                   support, Dbar being the weighted degree.
      * "sym_sep": Dp^-1/2 (A_p + tau_p 1 1^T) Dp^-1/2
                   - Dn^-1/2 (A_n + tau_n 1 1^T) Dn^-1/2, with Dp, Dn the
                   degrees of each side plus N tau.

    Every D^-1/2 floors the square root at 1/999999999."""
    A_p, A_n = sp.csc_matrix(A_p), sp.csc_matrix(A_n)
    n = A_p.shape[0]
    A = (A_p - A_n).tocsc()
    deg_p, deg_n = _column_sums(A_p), _column_sums(A_n)
    deg = deg_p + deg_n
    if tau_p is None or tau_n is None:
        tau_p = tau_n = 0.25 * np.mean(deg[deg != 0]) / n
    shift = tau_p - tau_n

    if normalization is None:
        def matvec(v):
            return A @ v + shift * v.sum()

    elif normalization == "sym":
        stored = []
        for M, tau in ((A_p, tau_p), (A_n, tau_n)):
            M = M.astype(np.float32)
            M.data += tau
            stored.append(M)
        d = _inv_sqrt(_column_sums(stored[0] + stored[1])
                      + (n - deg) * abs(shift))

        def matvec(v):
            return d * (A @ (d * v)) + shift * d * d.dot(v)

    elif normalization == "sym_sep":
        sides = [(M, sign, tau, _inv_sqrt(dg + n * tau))
                 for M, sign, tau, dg in ((A_p, 1.0, tau_p, deg_p),
                                          (A_n, -1.0, tau_n, deg_n))]

        def matvec(v):
            out = 0.0
            for M, sign, tau, d in sides:
                out = out + sign * (d * (M @ (d * v)) + tau * d * d.dot(v))
            return out

    else:
        raise NameError("Error in choosing normalization!")

    op = sp.linalg.LinearOperator(A.shape, matvec=matvec)
    w, v = sp.linalg.eigs(op, int(k if eigens is None else eigens),
                          maxiter=n if mi is None else mi, which="LR")
    return np.real(v * w).astype(np.float32)


def randomized_svd_components(M: sp.spmatrix, dim: int, n_iter: int = 128,
                              n_oversamples: int = 10,
                              random_state=None, device: DeviceLike = None):
    """[dim, M.shape[1]]: the leading right singular vectors of M by
    scikit-learn's ``TruncatedSVD(algorithm="randomized")``: a Gaussian
    range finder of dim + n_oversamples columns drawn from a
    ``RandomState`` (``random_state`` an int seeds one, None takes
    numpy's global one, as scikit-learn's ``check_random_state``),
    ``n_iter`` power iterations normalized by LU, a QR, the SVD of the
    small projection, and the sign of each vector fixed so that its
    largest-magnitude entry is positive.  The same calls in the same order
    as scikit-learn 1.9, so the same seed gives the same components.

    With a CUDA ``device`` the same range finder runs there in float64
    (``_range_finder_torch``) from the same start, and the components come
    back as a float64 tensor on that device; else a numpy array."""
    if random_state is None or random_state is np.random:
        rs = np.random.mtrand._rand
    elif isinstance(random_state, np.random.RandomState):
        rs = random_state
    else:
        rs = np.random.RandomState(random_state)
    M = sp.csr_matrix(M)
    Q = rs.normal(size=(M.shape[1], dim + n_oversamples))
    if device is not None and torch.device(device).type != "cpu":
        return _range_finder_torch(M, Q, dim, n_iter, torch.device(device))
    if M.dtype == np.float32:
        Q = Q.astype(np.float32, copy=False)
    for _ in range(n_iter):
        Q, _ = scipy.linalg.lu(M @ Q, permute_l=True, check_finite=False)
        Q, _ = scipy.linalg.lu(M.T @ Q, permute_l=True, check_finite=False)
    Q, _ = scipy.linalg.qr(M @ Q, mode="economic", check_finite=False)
    _, _, Vt = scipy.linalg.svd(Q.T @ M, full_matrices=False,
                                lapack_driver="gesdd")
    Vt = Vt[:dim]
    peak = np.abs(Vt).argmax(axis=1)
    return Vt * np.sign(Vt[np.arange(dim), peak])[:, None]


def _csr_tensor(M: sp.csr_matrix, device: torch.device) -> torch.Tensor:
    """A float64 ``torch.sparse`` CSR tensor of ``M`` on ``device``."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support")
        return torch.sparse_csr_tensor(
            *(torch.from_numpy(a).to(device) for a in (
                M.indptr.astype(np.int64), M.indices.astype(np.int64),
                M.data.astype(np.float64))),
            size=M.shape, dtype=torch.float64, device=device,
            check_invariants=False)


def _lu_permute_l(A: torch.Tensor) -> torch.Tensor:
    """``scipy.linalg.lu(A, permute_l=True)[0]`` for a tall [m, k] A: P @ L
    of its partially pivoted LU (L unit lower trapezoidal [m, k]).  The
    pivots are k row swaps, replayed on the host; P is never formed."""
    LU, piv = torch.linalg.lu_factor(A)
    _, L, _ = torch.lu_unpack(LU, piv, unpack_pivots=False)
    perm = np.arange(A.shape[0])
    for i, j in enumerate(piv.cpu().numpy() - 1):
        perm[i], perm[j] = perm[j], perm[i]
    # A[perm] = L U, so row perm[i] of P L is row i of L
    return torch.empty_like(L).index_copy_(
        0, torch.from_numpy(perm).to(A.device), L)


@contextlib.contextmanager
def _cusolver(device: torch.device):
    """torch's linear algebra on cuSOLVER inside the block, on CUDA."""
    if device.type != "cuda":
        yield
        return
    library = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(library)


def _range_finder_torch(M: sp.csr_matrix, Q: np.ndarray, dim: int,
                        n_iter: int, device: torch.device) -> torch.Tensor:
    """``randomized_svd_components``'s range finder in float64 on
    ``device`` from the start ``Q`` (drawn on the host): the products by
    ``torch.sparse`` CSR, the LU normalization as P @ L, then the QR, the
    SVD of the projection and the sign fix.  The factorizations take
    cuSOLVER (MAGMA's batched LU, which torch may pick for a single
    matrix, is slower on these tall blocks and prints to stdout)."""
    A, At = _csr_tensor(M, device), _csr_tensor(M.T.tocsr(), device)
    Q = torch.from_numpy(Q).to(device, torch.float64)
    with _cusolver(device):
        for _ in range(n_iter):
            Q = _lu_permute_l(A @ Q)
            Q = _lu_permute_l(At @ Q)
        Q, _ = torch.linalg.qr(A @ Q, mode="reduced")
        # the right singular vectors of Q^T M are the left ones of the
        # tall M^T Q
        U, _, _ = torch.linalg.svd(At @ Q, full_matrices=False)
    Vt = U.T[:dim]
    peak = Vt.abs().argmax(dim=1)
    sign = torch.sign(Vt[torch.arange(dim, device=device), peak])
    return Vt * sign[:, None]


def create_spectral_features(pos_edge_index, neg_edge_index, node_num: int,
                             dim: int, seed: Optional[int] = None,
                             device: DeviceLike = None):
    """[node_num, dim] float32: SGCN's input embedding, the leading right
    singular vectors of the symmetrized signed adjacency (+1 on positive
    pairs, -1 on negative ones, 0 where a pair is both, duplicates
    counted as in the original library) by ``randomized_svd_components``
    with 128 power iterations: a numpy array, or with a CUDA ``device`` a
    tensor on it (the power iterations there).  The span
    ``pgsd.prep.spectral_features``."""
    with span("prep.spectral_features", rows=node_num, dim=dim):
        pos = np.asarray(pos_edge_index)
        neg = np.asarray(neg_edge_index)
        row = np.concatenate([pos[0], neg[0], pos[1], neg[1]]).astype(
            np.int64)
        col = np.concatenate([pos[1], neg[1], pos[0], neg[0]]).astype(
            np.int64)
        val = np.tile(np.concatenate([np.full(pos.shape[1], 2.0),
                                      np.zeros(neg.shape[1])]), 2)
        keys, inverse = sorted_unique(row * node_num + col,
                                      return_inverse=True)
        summed = np.zeros(len(keys))
        np.add.at(summed, inverse, val)
        A = sp.coo_matrix((summed - 1.0, (keys // node_num, keys % node_num)),
                          shape=(node_num, node_num))
        V = randomized_svd_components(A, dim, random_state=seed,
                                      device=device)
        if isinstance(V, torch.Tensor):
            return V.T.to(torch.float32).contiguous()
        return V.T.astype(np.float32)
