"""SSSNET's balanced-cut objectives on cluster probabilities.

Counterpart of ``pytorch_geometric_signed_directed_tpu/utils/signed/
balanced_loss.py``.  Each loss freezes mat = D_p - (A_p - A_n) (and, for
the normalized cut, D_bar = D_p + D_n), D being row-degree diagonals, into
a Propagator when it is made, so every call applies the operator once:
one K1 call on the kernel tier (one K2 call a block where it streams).
"""
import scipy.sparse as sp
import torch

from ...device import DeviceLike
from ...ops.coo import coo_from_scipy
from ...ops.spmm import Propagator, propagator_from_coo


def _propagator(M: sp.spmatrix, mode: str, device: DeviceLike) -> Propagator:
    return propagator_from_coo(coo_from_scipy(M.tocsc(), device=device),
                               mode=mode)


def _row_degrees(A: sp.spmatrix) -> sp.spmatrix:
    return sp.diags(A.transpose().sum(axis=0).tolist(), [0]).tocsc()


def _cut_operator(A_p, A_n, mode, device) -> Propagator:
    return _propagator(_row_degrees(A_p) - (A_p - A_n), mode, device)


def _quadratic(prob: torch.Tensor, P: Propagator) -> torch.Tensor:
    """[K]: p_k^T M p_k for each column p_k of ``prob``."""
    return (prob * P(prob)).sum(dim=0)


class Prob_Balanced_Normalized_Loss:
    """sum_k p_k^T (D_p - A) p_k / (p_k^T D_bar p_k + 1e-6)."""

    def __init__(self, A_p: sp.spmatrix, A_n: sp.spmatrix, mode: str = "auto",
                 device: DeviceLike = None):
        self.mat = _cut_operator(A_p, A_n, mode, device)
        self.D_bar = _propagator(_row_degrees(A_p) + _row_degrees(A_n), mode,
                                 device)

    def __call__(self, prob: torch.Tensor) -> torch.Tensor:
        return (_quadratic(prob, self.mat)
                / (_quadratic(prob, self.D_bar) + 1e-6)).sum()


class Prob_Balanced_Ratio_Loss:
    """sum_k p_k^T (D_p - A) p_k / (p_k^T p_k + 1)."""

    def __init__(self, A_p: sp.spmatrix, A_n: sp.spmatrix, mode: str = "auto",
                 device: DeviceLike = None):
        self.mat = _cut_operator(A_p, A_n, mode, device)

    def __call__(self, prob: torch.Tensor) -> torch.Tensor:
        return (_quadratic(prob, self.mat)
                / ((prob * prob).sum(dim=0) + 1.0)).sum()


class Unhappy_Ratio:
    """sum_k p_k^T (D_p - A) p_k / the number of edges of A_p - A_n."""

    def __init__(self, A_p: sp.spmatrix, A_n: sp.spmatrix, mode: str = "auto",
                 device: DeviceLike = None):
        self.mat = _cut_operator(A_p, A_n, mode, device)
        self.num_edges = len((A_p - A_n).tocoo().nonzero()[0])

    def __call__(self, prob: torch.Tensor) -> torch.Tensor:
        return _quadratic(prob, self.mat).sum() / self.num_edges
