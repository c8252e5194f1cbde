"""Magnetic and signed magnetic Laplacians (host-side numpy/scipy).

Counterpart of ``pytorch_geometric_signed_directed_tpu/spectral/
magnetic.py``: the same arrays for the same input (from
``NATIVE_MIN_EDGES`` input edges on, both packages build the Laplacian
host arrays with the native tier).  For frozen q the
scaled Chebyshev operator pair L_hat = 2L/lambda_max - I is built once and
frozen into Propagators on a device.  For trainable q the q-independent
structure is a ``MagneticTemplate``, whose per-edge values are rebuilt for
each q with elementwise math; on the kernel tier ``template_dual_apply``
applies it with its own forward (the pair forward) and backward.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .. import native
from ..device import DeviceLike, resolve_device
from ..ops.coalesce import coalesce_edges
from ..ops.coo import COO, build_coo
from ..ops.cuda.scatter_csr import (RowSplit, csr_pair_spmm,
                                     csr_pair_spmm_accum)
from ..ops.layout import CsrBlock, build_layout
from ..ops.spmm import (
    DualPropagator,
    Propagator,
    _kernel_dtype,
    _layout_apply,
    _layout_fields,
    dual_propagator,
    propagator_from_coo,
    propagators_from_dual,
    resolve_mode,
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


# From this many input edges the host build takes the native tier, as
# the JAX package does.
NATIVE_MIN_EDGES = 1 << 20


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
    ei_arr = np.asarray(edge_index)
    if ei_arr.shape[1] >= NATIVE_MIN_EDGES:
        # one native pass builds both directions' keys and skips self-loops
        row, col, sym, theta, abs_sym = native.symmetrize(
            ei_arr[0], ei_arr[1], edge_weight, num_nodes)
        return row, col, sym / 2.0, theta, abs_sym / 2.0
    edge_index, edge_weight = _remove_self_loops(ei_arr, edge_weight)
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
    ei_arr = np.asarray(edge_index)
    if (normalization == "sym" and not return_lambda_max
            and ei_arr.shape[1] >= NATIVE_MIN_EDGES):
        # the whole build below (symmetrize, degree, normalization, phase,
        # diagonal) in one native pass, with the same float64 formulas
        w_in = (np.ones(ei_arr.shape[1], np.float64) if edge_weight is None
                else np.asarray(edge_weight, np.float64))
        deg_mode = 0 if not signed else (1 if absolute_degree else 2)
        orow, ocol, w_re, w_im = native.magnetic_sym_lap(
            ei_arr[0], ei_arr[1], w_in, num_nodes, q, deg_mode)
        return np.stack([orow, ocol]), w_re, w_im
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
    return magnetic_pair(*magnet_operator_arrays(
        edge_index, edge_weight, q=q, normalization=normalization,
        num_nodes=num_nodes, lambda_max=lambda_max, signed=signed,
        absolute_degree=absolute_degree), mode=mode, device=device)


def magnetic_pair(row, col, vre, vim, num_nodes: int, mode: str = "auto",
                  device: DeviceLike = None) -> MagneticPair:
    """The operator pair of ``magnet_operator_arrays``' output on
    ``device`` (None means "cuda"), in the tier ``mode`` picks."""
    device = resolve_device(device)
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


# ---------------------------------------------------------------------------
# Trainable q: the q-independent template and its applies


@dataclass(frozen=True)
class MagneticTemplate:
    """q-independent structure of the sym-normalized magnetic Laplacian.

    With sym normalization and lambda_max = 2 the scaled operator is purely
    off-diagonal: L_hat_re = -A_norm . cos(2 pi q Theta) and (transposed
    for the conv, see ``magnet_operator_arrays``) L_hat_im = A_norm .
    sin(2 pi q Theta), so a new q only recomputes per-edge values.

    ``dense`` holds ``a_norm`` and ``theta`` as [N, N] float32; ``segment``
    as per-edge float32 with int64 ``row``/``col`` sorted by (row, col);
    ``mxu`` in the kernel tier's layout order (the layout's ``col``,
    ``rowptr`` and its plan ``row_split`` or ``blocks``, hot table and
    stream, as in
    ``DualPropagator``), with ``transposed`` the same per-edge values in
    the transposed layout's order (cos is even and sin odd in theta, so the
    formulas give the transposed operator's values unchanged).
    ``mxu_sharded`` (parallel.build_sharded_template) holds a
    parallel.mxu_shard.ShardedMXU in ``sharded``; a dense or segment
    template sharded by parallel.shard_magnet_laplacian keeps its mode and
    holds a parallel.sharded.ShardedDense or ShardedSegment there."""

    a_norm: Optional[torch.Tensor]
    theta: Optional[torch.Tensor]
    row: Optional[torch.Tensor]
    col: Optional[torch.Tensor]
    num_nodes: int
    mode: str
    rowptr: Optional[torch.Tensor] = None
    blocks: Tuple[CsrBlock, ...] = ()
    hot_blocks: int = 0
    hot_ids: Optional[torch.Tensor] = None
    streamed: bool = False
    transposed: Optional["MagneticTemplate"] = None
    sharded: Optional[object] = None
    row_split: Optional[RowSplit] = None


def _mxu_template(row, col, a_norm, theta, num_nodes: int,
                  device) -> MagneticTemplate:
    a = torch.from_numpy(a_norm.astype(np.float32)).to(device)
    th = torch.from_numpy(theta.astype(np.float32)).to(device)
    # the transposed layout carries the ORIGINAL per-edge values
    L_t, p_t = build_layout(col, row, num_nodes, num_nodes, device)
    L, p = build_layout(row, col, num_nodes, num_nodes, device)
    t = MagneticTemplate(a_norm=a[p_t].contiguous(),
                         theta=th[p_t].contiguous(), row=None,
                         num_nodes=num_nodes, mode="mxu",
                         **_layout_fields(L_t))
    return MagneticTemplate(a_norm=a[p].contiguous(), theta=th[p].contiguous(),
                            row=None, num_nodes=num_nodes, mode="mxu",
                            transposed=t, **_layout_fields(L))


def magnetic_template(
    edge_index,
    edge_weight=None,
    num_nodes: Optional[int] = None,
    signed: bool = False,
    absolute_degree: bool = True,
    mode: str = "auto",
    device: DeviceLike = None,
) -> MagneticTemplate:
    """Host-side constructor of the trainable-q operator template on
    ``device`` (None means "cuda").  ``mode`` in {'auto', 'dense',
    'segment', 'mxu'}; 'auto' is dense up to 8192 nodes, else mxu.  The
    mxu layouts follow ops/layout.py's knobs at call time."""
    device = resolve_device(device)
    num_nodes = _maybe_num_nodes(edge_index, num_nodes)
    row, col, sym, theta, abs_sym = _symmetrize(edge_index, edge_weight,
                                                num_nodes)
    if not signed:
        deg_w = sym
    elif absolute_degree:
        deg_w = abs_sym
    else:
        deg_w = np.abs(sym)
    deg = np.zeros(num_nodes)
    np.add.at(deg, row, deg_w)
    deg_inv_sqrt = np.zeros_like(deg)
    nz = deg > 0
    deg_inv_sqrt[nz] = deg[nz] ** -0.5
    a_norm = deg_inv_sqrt[row] * sym * deg_inv_sqrt[col]

    mode = resolve_mode(mode, num_nodes, num_nodes)
    if mode == "dense":
        A = np.zeros((num_nodes, num_nodes), np.float32)
        T = np.zeros((num_nodes, num_nodes), np.float32)
        A[row, col] = a_norm
        T[row, col] = theta
        return MagneticTemplate(
            a_norm=torch.from_numpy(A).to(device),
            theta=torch.from_numpy(T).to(device), row=None, col=None,
            num_nodes=num_nodes, mode="dense")
    if mode == "mxu":
        return _mxu_template(row, col, a_norm, theta, num_nodes, device)
    if mode != "segment":
        raise ValueError(f"unknown template mode {mode!r}")
    # _symmetrize's edges are unique and sorted by (row, col)
    return MagneticTemplate(
        a_norm=torch.from_numpy(a_norm.astype(np.float32)).to(device),
        theta=torch.from_numpy(theta.astype(np.float32)).to(device),
        row=torch.from_numpy(row).to(device),
        col=torch.from_numpy(col).to(device), num_nodes=num_nodes,
        mode="segment")


def _edge_values(a_norm, theta, q):
    ang = 2.0 * math.pi * q * theta
    re_vals = -a_norm * torch.cos(ang)
    # plus: L_im's edge values are -a_norm*sin, and the conv applies L^T
    # (antisymmetric imaginary part -> negate; see magnet_operator_arrays)
    im_vals = a_norm * torch.sin(ang)
    return re_vals, im_vals


def _template_values(tmpl: MagneticTemplate, q):
    return _edge_values(tmpl.a_norm, tmpl.theta, q)


def template_propagators(tmpl: MagneticTemplate,
                         q) -> Tuple[Propagator, Propagator]:
    """(L_hat_re, L_hat_im) for phase ``q`` on a dense or segment template
    (sharded or not); the values carry q's gradient through autograd."""
    if tmpl.sharded is not None and tmpl.mode in ("dense", "segment"):
        return tmpl.sharded.template_propagators(q)
    re_vals, im_vals = _template_values(tmpl, q)
    if tmpl.mode == "dense":
        return (Propagator(coo=None, dense=re_vals, mode="dense"),
                Propagator(coo=None, dense=im_vals, mode="dense"))
    if tmpl.mode != "segment":
        raise ValueError(f"template_propagators takes dense and segment "
                         f"templates, not {tmpl.mode!r} (apply those with "
                         f"template_dual_apply)")
    n = tmpl.num_nodes

    def one(vals):
        return Propagator(coo=COO(row=tmpl.row, col=tmpl.col, val=vals,
                                  num_nodes=n, num_cols=n),
                          dense=None, mode="segment")

    return one(re_vals), one(im_vals)


def _dual_of(t: MagneticTemplate, val_a, val_b,
             transposed=None) -> DualPropagator:
    return DualPropagator(
        col=t.col, row=None, rowptr=t.rowptr, val_a=val_a, val_b=val_b,
        num_nodes=t.num_nodes, num_cols=t.num_nodes, mode="mxu",
        transposed=transposed, blocks=t.blocks, hot_blocks=t.hot_blocks,
        hot_ids=t.hot_ids, streamed=t.streamed, row_split=t.row_split)


def template_dual(tmpl: MagneticTemplate, q) -> DualPropagator:
    """The fused (L_hat_re, L_hat_im) DualPropagator for phase ``q`` on an
    mxu template: the template's layout with values computed for q."""
    if tmpl.mode != "mxu":
        raise ValueError(f"template_dual needs an mxu template, not "
                         f"{tmpl.mode!r}")
    t = None
    if tmpl.transposed is not None:
        t = _dual_of(tmpl.transposed, *_template_values(tmpl.transposed, q))
    return _dual_of(tmpl, *_template_values(tmpl, q), transposed=t)


def _template_terms(a, th, q):
    """Per-edge operator values and their derivatives by q, ``(va, vb, wa,
    wb)``: the formulas of ``_template_values`` (the conv's transpose baked
    into the imaginary part's sign) and ``w = d val / d q``.  cos is even
    and sin odd in theta, so they hold in a transposed layout's order."""
    ang = (2.0 * math.pi) * q * th
    scale = (2.0 * math.pi) * th * a
    return (-a * torch.cos(ang), a * torch.sin(ang),
            scale * torch.sin(ang), scale * torch.cos(ang))


def _template_pair_forward(tmpl: MagneticTemplate, q, x: torch.Tensor):
    """``(L(q) x, L'(q) x)`` through one pass over the edges.

    q is a scalar, so its directional derivative rides forward: each edge
    gathers its x row once and adds ``[va x_a | vb x_b]`` and ``[wa x_a |
    wb x_b]`` (``w = d val / d q``) to its row's two sums, through K1
    (``csr_pair_spmm``, which gathers x itself) on a flat layout or its
    accumulate mode once per block of a split or streamed one.  The kernel
    tiles any width, so every width takes one pass.  Returns (y [N, 2F] in
    x's type, y' [N, 2F] f32)."""
    if x.shape[1] % 2:
        raise ValueError(f"template_dual_apply needs an even lane-stacked "
                         f"width, got {x.shape[1]}")
    fa = x.shape[1] // 2
    f2 = 2 * fa
    xg = x.to(_kernel_dtype(x)).contiguous()
    terms = _template_terms(tmpl.a_norm, tmpl.theta, q)
    if not tmpl.blocks:
        out = csr_pair_spmm(tmpl.rowptr, tmpl.col, *terms, xg, fa,
                            tmpl.row_split)
    else:
        x_hot = xg.index_select(0, tmpl.hot_ids) \
            if tmpl.hot_ids is not None else None
        out = torch.zeros((tmpl.num_nodes, 2 * f2), dtype=torch.float32,
                          device=x.device)
        for i, b in enumerate(tmpl.blocks):
            s = slice(b.e0, b.e1)
            csr_pair_spmm_accum(b.rowptr, tmpl.col[s], *(v[s] for v in terms),
                                x_hot if i < tmpl.hot_blocks else xg, fa, out,
                                b.row0, b.split)
    return out[:, :f2].to(x.dtype), out[:, f2:]


class _TemplateDualApply(torch.autograd.Function):
    """Forward: the pair forward.  Backward: ``dq = <g, y'>`` (no kernel)
    and ``dx`` = the transposed dual apply of g (K1 or K2), skipped when
    x needs no gradient (the first apply of a model, whose input is
    data)."""

    @staticmethod
    def forward(ctx, x, q, tmpl):
        y, yp = _template_pair_forward(tmpl, q, x)
        ctx.tmpl = tmpl
        ctx.save_for_backward(q, yp)
        return y

    @staticmethod
    def backward(ctx, g):
        q, yp = ctx.saved_tensors
        tt = ctx.tmpl.transposed
        dq = dx = None
        if ctx.needs_input_grad[1]:
            dq = (g.float() * yp).sum().to(q.dtype).reshape(q.shape)
        if ctx.needs_input_grad[0]:
            g = g.contiguous()
            re_t, im_t = _template_values(tt, q)
            dx = _layout_apply(tt, re_t, im_t, tt.num_nodes, g,
                               g.shape[1] // 2)
        return dx, dq, None


def template_dual_apply(tmpl: MagneticTemplate, q,
                        x: torch.Tensor) -> torch.Tensor:
    """``[L_re x_a | L_im x_b]`` for phase ``q`` (a tensor that may need
    a gradient) on an mxu template (flat, column-split or streamed) or an
    ``mxu_sharded`` one, differentiable in q and x."""
    q = torch.as_tensor(q, dtype=torch.float32, device=x.device)
    if tmpl.mode == "mxu_sharded":
        return tmpl.sharded.template_dual_apply(q, x)
    if tmpl.mode != "mxu" or tmpl.transposed is None:
        raise ValueError("template_dual_apply needs an mxu template with "
                         "its transpose")
    return _TemplateDualApply.apply(x, q, tmpl)
