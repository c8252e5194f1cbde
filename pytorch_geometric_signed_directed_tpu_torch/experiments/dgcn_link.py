"""DGCN link prediction (direction / existence / three-class).

Counterpart of ``pytorch_geometric_signed_directed_tpu/experiments/
dgcn_link.py``: the same flags, defaults and printed lines, plus
``--device``.  The three streams (the symmetrized graph and the
second-order in and out graphs) are built from each split's observed
graph and GCN-normalized.
"""
import sys

import torch

from ..graph import directed_features_in_out, gcn_norm_propagator
from ..nn import DGCN_link_prediction
from . import _directed_link

propagator = gcn_norm_propagator


def parser():
    return _directed_link.parser("dgcn_link", alpha=False)


def operator_arrays(args, g, w, n):
    idx_und, edge_in, in_w, edge_out, out_w = directed_features_in_out(
        g, n, w)
    return [(idx_und, None), (edge_in, in_w), (edge_out, out_w)]


def make_model(args, inputs) -> DGCN_link_prediction:
    return DGCN_link_prediction(
        num_features=2, hidden=args.hidden, label_dim=inputs.label_dim,
        device=inputs.device,
        generator=torch.Generator().manual_seed(args.seed))


def main(argv=None) -> dict:
    return _directed_link.main(argv, sys.modules[__name__])


if __name__ == "__main__":
    main()
