"""Sharding a built operator, pair or template across a mesh.

Counterpart of ``pytorch_geometric_signed_directed_tpu/parallel/
sharded.py``, kernel tier (``mxu``) only: its operators re-partition into
the owner-computes shards of parallel/mxu_shard.py.  Sharding the dense,
segment and bsr tiers (GSPMD placements in the JAX package) is later work
(ROADMAP.md queue A, item 17) and raises here.
"""
from __future__ import annotations

import torch

from ..ops.spmm import DualPropagator, Propagator
from .mesh import Mesh
from .mxu_shard import (
    _coo_from_dual,
    _coo_from_mxu,
    build_sharded_mxu,
    build_sharded_template,
)


def _not_yet(what: str):
    return NotImplementedError(
        f"sharding {what} is not ported yet (ROADMAP.md queue A, item 17); "
        f"only the mxu tier shards")


def replicate(tree, mesh: Mesh):
    """Place a tensor or module (or a dict, list or tuple of them) on the
    mesh's controller device, where the sharded applies read their
    replicated inputs."""
    if isinstance(tree, (torch.Tensor, torch.nn.Module)):
        return tree.to(mesh.devices[0])
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    return tree


def shard_propagator(prop: Propagator, mesh: Mesh) -> Propagator:
    """Re-partition an mxu Propagator into per-device CSRs."""
    if prop.mode != "mxu":
        raise _not_yet(f"a {prop.mode!r} Propagator")
    row, col, val = _coo_from_mxu(prop.csr)
    S = build_sharded_mxu(row, col, val, prop.csr.num_rows,
                          prop.csr.num_cols, mesh)
    return Propagator(coo=None, dense=None, mode="mxu_sharded", sharded=S)


def shard_dual(dual, mesh: Mesh):
    """Re-partition an mxu DualPropagator (None stays None)."""
    if dual is None:
        return None
    if dual.mode != "mxu":
        raise _not_yet(f"a {dual.mode!r} DualPropagator")
    row, col, va, vb = _coo_from_dual(dual)
    S = build_sharded_mxu(row, col, va, dual.num_nodes, dual.num_cols, mesh,
                          val_b=vb)

    def wrap(s):
        if s is None:
            return None
        return DualPropagator(
            col=None, row=None, rowptr=None, val_a=None, val_b=None,
            num_nodes=s.num_rows, num_cols=s.num_cols, mode="mxu_sharded",
            transposed=wrap(s.transposed), sharded=s)

    return wrap(S)


def shard_magnet_laplacian(lap, mesh: Mesh):
    """Shard a MagneticPair, a (P_re, P_im) pair or an mxu
    MagneticTemplate."""
    from ..spectral.magnetic import MagneticPair, MagneticTemplate

    if isinstance(lap, MagneticPair):
        return MagneticPair(re=shard_propagator(lap.re, mesh),
                            im=shard_propagator(lap.im, mesh),
                            dual=shard_dual(lap.dual, mesh))
    if isinstance(lap, MagneticTemplate):
        if lap.mode == "mxu":
            return build_sharded_template(lap, mesh)
        if lap.mode == "mxu_sharded":
            return lap
        raise _not_yet(f"a {lap.mode!r} MagneticTemplate")
    P_re, P_im = lap
    return shard_propagator(P_re, mesh), shard_propagator(P_im, mesh)
