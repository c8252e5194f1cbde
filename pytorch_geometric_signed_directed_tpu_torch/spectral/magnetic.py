"""Magnetic and signed magnetic Laplacians (host-side numpy/scipy).

Counterpart of ``pytorch_geometric_signed_directed_tpu/spectral/
magnetic.py`` for frozen q: the same arrays for the same input.  The
scaled Chebyshev operator pair L_hat = 2L/lambda_max - I is built once
and frozen into Propagators on a device.  Trainable q (``MagneticTemplate``)
waits for a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..device import DeviceLike, resolve_device
from ..ops.coalesce import coalesce_edges
from ..ops.coo import build_coo
from ..ops.spmm import (
    DualPropagator,
    Propagator,
    dual_propagator,
    propagator_from_coo,
    propagators_from_dual,
)


@dataclass(frozen=True)
class MagneticPair:
    """(L_hat_re, L_hat_im) + the fused same-structure operator.

    Unpacks like a plain tuple (``P_re, P_im = pair``).  ``dual`` is set
    on the sparse tiers, where both operators apply as one lane-stacked
    gather + sum; None on the dense tier."""

    re: Propagator
    im: Propagator
    dual: Optional[DualPropagator] = None

    def __iter__(self):
        return iter((self.re, self.im))

    def __len__(self):
        return 2

    def __getitem__(self, i):
        return (self.re, self.im)[i]


def _remove_self_loops(edge_index, edge_weight):
    edge_index = np.asarray(edge_index)
    mask = edge_index[0] != edge_index[1]
    ew = None if edge_weight is None else np.asarray(edge_weight)[mask]
    return edge_index[:, mask], ew


def _symmetrize(edge_index, edge_weight, num_nodes):
    """Coalesced symmetrization: per unique (i, j) with i != j returns
    sym = (w_ij + w_ji)/2, theta = w_ij - w_ji, abs_sym = (|w_ij|+|w_ji|)/2,
    sorted by (row, col)."""
    if edge_weight is None:
        edge_weight = np.ones(np.asarray(edge_index).shape[1],
                              dtype=np.float64)
    else:
        edge_weight = np.asarray(edge_weight, dtype=np.float64)
    edge_index, edge_weight = _remove_self_loops(np.asarray(edge_index),
                                                 edge_weight)
    row0, col0 = edge_index[0], edge_index[1]
    r = np.concatenate([row0, col0])
    c = np.concatenate([col0, row0])
    sym_attr = np.concatenate([edge_weight, edge_weight])
    theta_attr = np.concatenate([edge_weight, -edge_weight])
    abs_attr = np.concatenate([np.abs(edge_weight), np.abs(edge_weight)])

    row, col, sym, theta, abs_sym = coalesce_edges(
        r, c, sym_attr, theta_attr, abs_attr, num_cols=num_nodes)
    return row, col, sym / 2.0, theta, abs_sym / 2.0


def _maybe_num_nodes(edge_index, num_nodes):
    if num_nodes is not None:
        return int(num_nodes)
    edge_index = np.asarray(edge_index)
    return int(edge_index.max()) + 1 if edge_index.size else 0


def _laplacian_core(
    edge_index,
    edge_weight,
    normalization: Optional[str],
    num_nodes: Optional[int],
    q: float,
    return_lambda_max: bool,
    signed: bool,
    absolute_degree: bool = True,
):
    if normalization not in (None, "sym"):
        raise ValueError(f"invalid normalization {normalization!r}")
    num_nodes = _maybe_num_nodes(edge_index, num_nodes)
    row, col, sym, theta, abs_sym = _symmetrize(edge_index, edge_weight,
                                                num_nodes)

    if not signed:
        deg_w = sym
    elif absolute_degree:
        deg_w = abs_sym
    else:
        deg_w = np.abs(sym)
    deg = np.bincount(row, weights=deg_w, minlength=num_nodes)

    ang = (2 * np.pi * q) * theta
    cos_p, sin_p = np.cos(ang), np.sin(ang)

    # edges first, then the N diagonal entries
    out_row = np.concatenate([row, np.arange(num_nodes)])
    out_col = np.concatenate([col, np.arange(num_nodes)])
    if normalization is None:
        # L = D - A_sym . exp(i Theta)
        w_re = np.concatenate([-sym * cos_p, deg])
        w_im = np.concatenate([-sym * sin_p, np.zeros(num_nodes)])
    else:
        deg_inv_sqrt = np.zeros_like(deg)
        nz = deg > 0
        deg_inv_sqrt[nz] = deg[nz] ** -0.5
        norm_w = deg_inv_sqrt[row] * sym * deg_inv_sqrt[col]
        w_re = np.concatenate([-norm_w * cos_p, np.ones(num_nodes)])
        w_im = np.concatenate([-norm_w * sin_p, np.zeros(num_nodes)])

    edge_index_out = np.stack([out_row, out_col])
    if not return_lambda_max:
        return edge_index_out, w_re, w_im
    import scipy.sparse as sp
    from scipy.sparse.linalg import eigsh

    L = sp.coo_matrix((w_re + 1j * w_im, (out_row, out_col)),
                      shape=(num_nodes, num_nodes))
    lambda_max = eigsh(L.tocsr(), k=1, which="LM", return_eigenvectors=False)
    lambda_max = float(np.asarray(lambda_max).real.item())
    return edge_index_out, w_re, w_im, lambda_max


def magnetic_laplacian(
    edge_index,
    edge_weight=None,
    normalization: Optional[str] = "sym",
    num_nodes: Optional[int] = None,
    q: float = 0.25,
    return_lambda_max: bool = False,
):
    """Magnetic Laplacian of a directed graph (MagNet, NeurIPS'21).

    Returns ``(edge_index [2, E'], w_real, w_imag[, lambda_max])`` as numpy:
    the unique off-diagonal entries sorted by (row, col), then the N
    diagonal entries."""
    return _laplacian_core(edge_index, edge_weight, normalization, num_nodes,
                           q, return_lambda_max, signed=False)


def magnetic_signed_laplacian(
    edge_index,
    edge_weight=None,
    normalization: Optional[str] = "sym",
    num_nodes: Optional[int] = None,
    q: float = 0.25,
    return_lambda_max: bool = False,
    absolute_degree: bool = True,
):
    """Signed magnetic Laplacian (MSGNN, LoG'22)."""
    return _laplacian_core(edge_index, edge_weight, normalization, num_nodes,
                           q, return_lambda_max, signed=True,
                           absolute_degree=absolute_degree)


def magnet_operator_arrays(
    edge_index,
    edge_weight=None,
    q: float = 0.25,
    normalization: Optional[str] = "sym",
    num_nodes: Optional[int] = None,
    lambda_max: Optional[float] = None,
    signed: bool = False,
    absolute_degree: bool = True,
):
    """The shared edge list of the scaled Chebyshev operator pair
    (L_hat_re, L_hat_im), as host numpy: ``(row, col, w_re, w_im,
    num_nodes)`` sorted by (row, col), diagonal entries included.

    Orientation: the original MagNetConv's propagate computes
    ``out[tgt] += norm * x[src]``, i.e. it multiplies by L_hat^T.  L_re is
    symmetric and L_im antisymmetric, so the transpose is baked in here by
    negating the imaginary operator.
    """
    num_nodes = _maybe_num_nodes(edge_index, num_nodes)
    fn = magnetic_signed_laplacian if signed else magnetic_laplacian
    kwargs = dict(normalization=normalization, num_nodes=num_nodes, q=q)
    if signed:
        kwargs["absolute_degree"] = absolute_degree
    if normalization != "sym" and lambda_max is None:
        ei, w_re, w_im, lambda_max = fn(
            edge_index, edge_weight, return_lambda_max=True, **kwargs)
    else:
        ei, w_re, w_im = fn(edge_index, edge_weight, **kwargs)
    if lambda_max is None:
        lambda_max = 2.0

    w_re = 2.0 * w_re / lambda_max
    # minus: the conv applies L^T and L_im is antisymmetric (see docstring)
    w_im = -2.0 * w_im / lambda_max
    # L_hat = 2L/lambda - I: the -I lands on the trailing diagonal section
    # of the real part; the imaginary part keeps explicit zero-weight loops
    # so both operators share one structure (what the fused dual needs).
    # Edges and loops are two sorted unique key runs: merge, not re-sort.
    loops = np.arange(num_nodes)
    e_off = ei.shape[1] - num_nodes
    if not (np.array_equal(ei[0, e_off:], loops)
            and np.array_equal(ei[1, e_off:], loops)):
        raise ValueError("unexpected Laplacian layout (trailing diagonal)")
    w_re[e_off:] -= 1.0
    ke = ei[0, :e_off] * np.int64(num_nodes) + ei[1, :e_off]
    kl = loops * np.int64(num_nodes) + loops
    # the merge requires ke and kl disjoint; a collision would leave a
    # slot unwritten, so fail loud instead
    diag_hits = np.searchsorted(ke, kl)
    if len(ke):
        hit = diag_hits < len(ke)
        if np.any(ke[diag_hits[hit]] == kl[hit]):
            raise ValueError(
                "diagonal entry in the Laplacian edge section")
    edge_dst = np.arange(e_off) + np.searchsorted(kl, ke)
    loop_dst = diag_hits + loops
    total = e_off + num_nodes
    row = np.empty(total, np.int64)
    col = np.empty(total, np.int64)
    vre = np.empty(total, w_re.dtype)
    vim = np.empty(total, w_im.dtype)
    for dst, sl in ((edge_dst, slice(None, e_off)),
                    (loop_dst, slice(e_off, None))):
        row[dst] = ei[0, sl]
        col[dst] = ei[1, sl]
        vre[dst] = w_re[sl]
        vim[dst] = w_im[sl]
    return row, col, vre, vim, num_nodes


def magnet_propagators(
    edge_index,
    edge_weight=None,
    q: float = 0.25,
    normalization: Optional[str] = "sym",
    num_nodes: Optional[int] = None,
    lambda_max: Optional[float] = None,
    mode: str = "auto",
    signed: bool = False,
    absolute_degree: bool = True,
    device: DeviceLike = None,
) -> MagneticPair:
    """Build the scaled Chebyshev operator pair (L_hat_re, L_hat_im) of
    ``magnet_operator_arrays`` on ``device`` (None means "cuda")."""
    device = resolve_device(device)
    row, col, vre, vim, num_nodes = magnet_operator_arrays(
        edge_index, edge_weight, q=q, normalization=normalization,
        num_nodes=num_nodes, lambda_max=lambda_max, signed=signed,
        absolute_degree=absolute_degree)
    dual = dual_propagator(row, col, vre, vim, num_nodes, mode=mode,
                           device=device)
    # on the kernel tier the dual carries the hot path and the single
    # operators are views over its tensors
    if dual is not None and dual.mode == "mxu":
        P_re, P_im = propagators_from_dual(dual)
        return MagneticPair(re=P_re, im=P_im, dual=dual)
    single_mode = ("segment" if (dual is not None and mode == "auto")
                   else mode)
    A_re = build_coo(row, col, vre, num_nodes, device=device)
    A_im = build_coo(row, col, vim, num_nodes, device=device)
    return MagneticPair(
        re=propagator_from_coo(A_re, mode=single_mode),
        im=propagator_from_coo(A_im, mode=single_mode),
        dual=dual,
    )
