"""Carry MagNet and MSGNN weights over from the JAX package's parameter
tree.

``state_dict_from_jax`` takes the flax tree as nested dicts of numpy
arrays (``jax.device_get(params)`` gives one) and returns the port's
``state_dict``, so both packages can compute with the same weights.
"""
import re
from typing import Dict, Mapping

import numpy as np
import torch

_CONV = re.compile(r"(?:MagNetConv|MSConv)_(\d+)$")


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``{'params': {'MagNetConv_i': {'weight' [K+1,in,out], 'bias'[,
    'q' [1]]}, 'Dense_0': {'kernel' [in,out], 'bias'}}}`` -> the state_dict
    of ``MagNet_node_classification`` / ``MagNet_link_prediction`` (or,
    for a bare ``{'params': {'weight', 'bias'[, 'q']}}``, of one
    ``MagNetConv``).  MSGNN's tree holds its convs one level down,
    ``{'_MSGNNTrunk_0': {'MSConv_i': {...}}, 'Dense_0': ...}``, and maps
    onto the state_dict of ``MSGNN_node_classification`` /
    ``MSGNN_link_prediction``.  The Dense kernel is transposed into the
    Linear weight; a trainable-q conv's ``q`` leaf carries over as it is."""
    tree = dict(params.get("params", params))
    tree.update(tree.pop("_MSGNNTrunk_0", {}))

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    out: Dict[str, torch.Tensor] = {}
    for name, leaf in tree.items():
        m = _CONV.match(name)
        if m:
            for k, v in leaf.items():
                out[f"convs.{m.group(1)}.{k}"] = t(v)
        elif name == "Dense_0":
            out["linear.weight"] = t(leaf["kernel"]).T.contiguous()
            out["linear.bias"] = t(leaf["bias"])
        elif name in ("weight", "bias", "q"):
            out[name] = t(leaf)
        else:
            raise KeyError(f"unexpected parameter group {name!r}")
    return out
