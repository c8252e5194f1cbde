"""DGCN node classification on a real directed dataset.

Counterpart of ``pytorch_geometric_signed_directed_tpu/experiments/
dgcn_node.py``: the same flags, defaults and printed lines, plus
``--device``.  The symmetrized graph and the second-order in and out
graphs (``directed_features_in_out``), GCN-normalized; binarized weights
and in/out-degree features by default (``--weights raw --features x``
is the original recipe); one run a mask split.
"""
import argparse
import sys

import numpy as np
import torch

from ..device import DeviceLike
from ..graph import directed_features_in_out, gcn_norm_propagator
from ..nn import DGCN_node_classification
from . import _directed_node
from ._common import add_device_arg, result

propagator = gcn_norm_propagator
features = _directed_node.flag_features


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m pytorch_geometric_signed_directed_tpu_torch "
        "dgcn_node")
    ap.add_argument("--dataset", default="telegram")
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--weight_decay", type=float, default=5e-4)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--dropout", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--weights", choices=("raw", "binary", "log"),
                    default="binary")
    ap.add_argument("--features", choices=("x", "deg"), default="deg")
    add_device_arg(ap)
    return ap


def build_propagators(data, n: int, device: DeviceLike = None) -> tuple:
    """The symmetrized, in and out graphs of ``data`` (its own edge
    weights), GCN-normalized Propagators on ``device``: the JAX module's
    public ``build_propagators``."""
    return tuple(propagator(ei, ew, n, device=device)
                 for ei, ew in operator_arrays(None, data, data.edge_weight,
                                               n))


def operator_arrays(args, data, w, n):
    idx_und, edge_in, in_w, edge_out, out_w = directed_features_in_out(
        data.edge_index, n, w)
    return [(idx_und, None), (edge_in, in_w), (edge_out, out_w)]


def make_model(args, inputs, split: int) -> DGCN_node_classification:
    return DGCN_node_classification(
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
