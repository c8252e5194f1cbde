"""DiGCN inception-block link prediction over the PPR and second-order
adjacencies of the observed graph.

Counterpart of ``pytorch_geometric_signed_directed_tpu/experiments/
digcn_inception_link.py``: the same flags, defaults and printed lines,
plus ``--device``.
"""
import sys

import torch

from ..graph import norm_propagator
from ..nn import DiGCN_Inception_Block_link_prediction
from ..spectral import appr_directed_adj, second_directed_adj
from . import _directed_link

propagator = norm_propagator


def parser():
    return _directed_link.parser("digcn_inception_link", alpha=True)


def operator_arrays(args, g, w, n):
    return [appr_directed_adj(args.alpha, g, n, w),
            second_directed_adj(g, n, w)]


def make_model(args, inputs) -> DiGCN_Inception_Block_link_prediction:
    return DiGCN_Inception_Block_link_prediction(
        num_features=2, hidden=args.hidden, label_dim=inputs.label_dim,
        device=inputs.device,
        generator=torch.Generator().manual_seed(args.seed))


def main(argv=None) -> dict:
    return _directed_link.main(argv, sys.modules[__name__])


if __name__ == "__main__":
    main()
