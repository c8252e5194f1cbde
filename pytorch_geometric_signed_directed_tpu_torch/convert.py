"""Carry weights over from the JAX package's parameter tree.

``state_dict_from_jax`` takes the flax tree as nested dicts of numpy
arrays (``jax.device_get(params)`` gives one) and returns the port's
``state_dict``, so both packages can compute with the same weights.
"""
import re
from typing import Dict, Mapping

import numpy as np
import torch

# flax group name -> the port's module path ("" flattens the group)
_GROUPS = (
    (re.compile(r"(?:MagNetConv|MSConv|DiGCNConv)_(\d+)$"), r"convs.\1"),
    (re.compile(r"convs_(\d+)$"), r"convs.\1"),
    (re.compile(r"DiGCN_Inception_Block_(\d+)$"), r"blocks.\1"),
    (re.compile(r"Dense_0$"), "linear"),
    (re.compile(r"Dense_(\d+)$"), r"linear\1"),
    (re.compile(r"(w_(?:[st]|[st]?[pn])[01])$"), r"\1"),
    (re.compile(r"(conv1|lin_[bu]|lsp_loss|score_function[12]|alpha_[bu]"
                r"|weight|mlp[12]|agg_stack|loss_direction|loss_tri)$"),
     r"\1"),
    (re.compile(r"agg_(\d+)$"), r"aggs.\1"),
    (re.compile(r"SDRLayer_(\d+)$"), r"layers.\1"),
    (re.compile(r"DIMPA_0$"), "dimpa"),
    (re.compile(r"SIMPA_0$"), "simpa"),
    (re.compile(r"_(?:DGCN|SSSNET)Trunk_0$"), "trunk"),
    (re.compile(r"_MSGNNTrunk_0$"), ""),
)


def _group(name: str) -> str:
    for pattern, path in _GROUPS:
        if pattern.match(name):
            return pattern.sub(path, name)
    raise KeyError(f"unexpected parameter group {name!r}")


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The flax tree of a model of the port's families -> its state_dict.

    Groups map by ``_GROUPS``: conv layers ``MagNetConv_i`` / ``MSConv_i``
    / ``DiGCNConv_i`` and SGCN's ``convs_i`` -> ``convs.i``,
    ``DiGCN_Inception_Block_i`` -> ``blocks.i``, ``Dense_0`` -> ``linear``
    (``Dense_i`` -> ``linear{i}``), DIGRAC's ``w_s0``.. ``w_t1`` and
    SSSNET's ``w_p0``.. ``w_tn1`` keep their names, ``DIMPA_0`` ->
    ``dimpa``, ``SIMPA_0`` -> ``simpa``, DGCN's and SSSNET's trunks ->
    ``trunk``, SGCN's and SNEA's ``conv1``, ``lin_b``/``lin_u``,
    ``lsp_loss``, SNEA's ``alpha_b``/``alpha_u`` and ``weight``, SiGAT's
    ``mlp1``/``mlp2`` and ``agg_stack``, and SDGNN's ``loss_direction``,
    ``loss_tri`` and ``score_function1/2`` keep theirs; the motif GATs
    ``agg_i`` -> ``aggs.i``, SDGNN's ``SDRLayer_i`` -> ``layers.i``;
    MSGNN's ``_MSGNNTrunk_0`` is flattened.  Leaves keep their names
    (``weight``, ``bias``, ``q``, ``W_prob``, ``bias1``, ``_w_s``,
    ``_w_sp``, ``att_src``, the trainable ``x``, ...), except a Dense
    ``kernel`` [in, out], which becomes the Linear's ``weight`` [out, in]
    (the motif stack's [G, in, out] ``kernel`` keeps its name and shape).
    A bare conv tree ``{'params': {'weight', 'bias'[, 'q']}}`` maps onto
    one MagNetConv."""

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: str) -> None:
        for name, leaf in tree.items():
            if isinstance(leaf, Mapping):
                path = _group(name)
                walk(leaf, prefix + path + "." if path else prefix)
            elif name == "kernel" and np.ndim(leaf) == 2:
                out[prefix + "weight"] = t(leaf).T.contiguous()
            else:
                out[prefix + name] = t(leaf)

    walk(params.get("params", params), "")
    return out
