"""Carry MagNet weights over from the JAX package's parameter tree.

``state_dict_from_jax`` takes the flax tree as nested dicts of numpy
arrays (``jax.device_get(params)`` gives one) and returns the port's
``state_dict``, so both packages can compute with the same weights.
"""
import re
from typing import Dict, Mapping

import numpy as np
import torch

_CONV = re.compile(r"MagNetConv_(\d+)$")


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``{'params': {'MagNetConv_i': {'weight' [K+1,in,out], 'bias'},
    'Dense_0': {'kernel' [in,out], 'bias'}}}`` -> the state_dict of
    ``MagNet_node_classification`` / ``MagNet_link_prediction`` (or, for
    a bare ``{'params': {'weight', 'bias'}}``, of one ``MagNetConv``).
    The Dense kernel is transposed into the Linear weight."""
    tree = params.get("params", params)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    out: Dict[str, torch.Tensor] = {}
    for name, leaf in tree.items():
        m = _CONV.match(name)
        if m:
            for k, v in leaf.items():
                if k == "q":
                    raise NotImplementedError(
                        "trainable-q parameters are not ported yet")
                out[f"convs.{m.group(1)}.{k}"] = t(v)
        elif name == "Dense_0":
            out["linear.weight"] = t(leaf["kernel"]).T.contiguous()
            out["linear.bias"] = t(leaf["bias"])
        elif name in ("weight", "bias"):
            out[name] = t(leaf)
        else:
            raise KeyError(f"unexpected parameter group {name!r}")
    return out
