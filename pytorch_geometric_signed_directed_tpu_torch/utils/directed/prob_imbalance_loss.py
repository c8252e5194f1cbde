"""DIGRAC's probabilistic imbalance loss, vectorized.

Counterpart of ``pytorch_geometric_signed_directed_tpu/utils/directed/
prob_imbalance_loss.py``.  The pairwise flows W = P^T A P are one matmul
chain and the thresholding (sort / std / naive) is mask arithmetic, so
the loss makes no host sync.
"""
from typing import Optional, Union

import numpy as np
import torch

from ...instrument import layer
from ...ops.spmm import DualPropagator, dual_spmm_stacked


class Prob_Imbalance_Loss:
    """F: either an int (the number of pairwise scores kept under 'sort')
    or the meta-graph adjacency, from which sel = #{i<j : F_ij + F_ji > 0}.
    As in the JAX package, only a Python ``int`` counts as the former."""

    def __init__(self, F: Optional[Union[int, np.ndarray]] = None):
        if isinstance(F, int):
            self.sel = F
        elif F is not None:
            K = F.shape[0]
            self.sel = 0
            for i in range(K - 1):
                for j in range(i + 1, K):
                    if (F[i, j] + F[j, i]) > 0:
                        self.sel += 1
        else:
            self.sel = None

    @layer("loss.prob_imbalance")
    def __call__(self, P: torch.Tensor, A, K: int,
                 normalization: str = "vol_sum",
                 threshold: str = "sort") -> torch.Tensor:
        """``P`` [N, K] cluster probabilities.  ``A``: a dense [N, N]
        adjacency, a (P_A, P_AT) pair of Propagators, or one
        DualPropagator computing [A P | A^T P] in one apply
        (``graph.adj_dual_propagator``)."""
        assert normalization in ("vol_sum", "vol_min", "vol_max", "plain"), \
            "Please input the correct normalization method name!"
        assert threshold in ("sort", "std", "naive"), \
            "Please input the correct threshold method name!"
        eps = 1e-8
        if isinstance(A, tuple):
            P_A, P_AT = A
            AP, ATP = P_A(P), P_AT(P)
        elif isinstance(A, DualPropagator):
            k = P.shape[1]
            stacked = dual_spmm_stacked(A, torch.cat([P, P], dim=1))
            AP, ATP = stacked[:, :k], stacked[:, k:]
        else:
            A = torch.as_tensor(A, dtype=P.dtype, device=P.device)
            AP, ATP = A @ P, A.T @ P
        vol = (AP + ATP).sum(dim=0)  # [K]
        second_max_vol = torch.sort(vol).values[-2] + eps
        W = P.T @ AP  # [K, K] pairwise flows: W[k, l] = P_k^T A P_l

        # np.triu_indices(K, k=1)'s pairs, made on P's device: a copy
        # from host memory would make the step wait for the device
        iu, ju = torch.triu_indices(K, K, offset=1, device=P.device)
        w_kl, w_lk = W[iu, ju], W[ju, iu]
        diff = (w_kl - w_lk).abs()
        denom_pair = w_kl + w_lk

        if normalization == "vol_sum":
            curr = diff / (vol[iu] + vol[ju] + eps) * 2
        elif normalization == "vol_min":
            curr = diff / (denom_pair + eps) * torch.minimum(
                vol[iu], vol[ju]) / second_max_vol
        elif normalization == "vol_max":
            curr = diff / (torch.maximum(vol[iu], vol[ju]) + eps)
        else:  # plain
            curr = diff / (denom_pair + eps)

        nonzero = diff != 0
        curr = torch.where(nonzero, curr, torch.zeros_like(curr))

        if threshold == "sort":
            sel = int(self.sel)
            top = torch.sort(curr, descending=True).values[:sel]
            return 1.0 - top.sum() / sel
        one = torch.ones_like(curr[0])
        if threshold == "naive":
            cnt = nonzero.sum()
            return torch.where(cnt > 0,
                               1.0 - curr.sum() / cnt.clamp(min=1), one)
        # 'std': keep pairs with (w_kl - w_lk)^2 - 9 (w_kl + w_lk) > 0; the
        # mean over every nonzero pair when none passes
        passing = nonzero & ((w_kl - w_lk) ** 2 - 9.0 * denom_pair > 0)
        n_pass, n_nz = passing.sum(), nonzero.sum()
        mean_pass = (torch.where(passing, curr, torch.zeros_like(curr)).sum()
                     / n_pass.clamp(min=1))
        mean_all = curr.sum() / n_nz.clamp(min=1)
        return torch.where(n_pass > 0, 1.0 - mean_pass,
                           torch.where(n_nz > 0, 1.0 - mean_all, one))
