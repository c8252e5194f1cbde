"""DiGCN node classification over the PPR adjacency of a real directed
dataset.

Counterpart of ``pytorch_geometric_signed_directed_tpu/experiments/
digcn_node.py``: the same flags, defaults and printed lines, plus
``--device``.  The dataset's own features (in/out degrees where it has
none), two DiGCN convolutions over ``appr_directed_adj``; one run a mask
split.
"""
import argparse
import sys

import numpy as np
import torch

from ..graph import in_out_degree, norm_propagator
from ..nn import DiGCN_node_classification
from ..spectral import appr_directed_adj
from . import _directed_node
from ._common import add_device_arg, result

propagator = norm_propagator


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m pytorch_geometric_signed_directed_tpu_torch "
        "digcn_node")
    ap.add_argument("--dataset", default="telegram")
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--weight_decay", type=float, default=5e-4)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--dropout", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    return ap


def features(args, data, w) -> np.ndarray:
    """The dataset's own features, else its raw in/out degrees."""
    if data.x is not None:
        return np.asarray(data.x, np.float32)
    return in_out_degree(data.edge_index, data.num_nodes,
                         edge_weight=data.edge_weight)


def operator_arrays(args, data, w, n):
    # the raw weights (no --weights flag here), as the JAX experiment
    return [appr_directed_adj(args.alpha, data.edge_index, n,
                              data.edge_weight)]


def make_model(args, inputs, split: int) -> DiGCN_node_classification:
    return DiGCN_node_classification(
        num_features=int(inputs.x.shape[1]), hidden=args.hidden,
        label_dim=inputs.label_dim, dropout=args.dropout,
        device=inputs.device,
        generator=torch.Generator().manual_seed(args.seed + split))


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    exp = sys.modules[__name__]
    inputs = _directed_node.build_inputs(args, args.device, exp)
    runs = []
    for split in range(inputs.data.train_mask.shape[1]):
        r = _directed_node.train_split(args, inputs, split,
                                       make_model(args, inputs, split))
        runs.append(r)
        print(f"split {split}: test acc {r['acc']:.4f}")
    accs = [r["acc"] for r in runs]
    print(f"mean test acc: {np.mean(accs):.4f} +/- {np.std(accs):.4f}")
    return result(inputs, runs)


if __name__ == "__main__":
    main()
