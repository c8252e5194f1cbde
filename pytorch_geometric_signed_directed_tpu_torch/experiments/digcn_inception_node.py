"""DiGCN inception-block node classification on a real directed dataset.

Counterpart of ``pytorch_geometric_signed_directed_tpu/experiments/
digcn_inception_node.py``: the same flags, defaults and printed lines,
plus ``--device``.  The PPR and second-order adjacencies, three inception
blocks, binarized weights and in/out-degree features by default
(``--weights raw --features x`` is the original recipe), dropout drawn
from a generator seeded ``--seed``; the test accuracy of each mask split
is that at its best validation accuracy, evaluated every
``epochs // 50`` steps.
"""
import argparse
import sys

import numpy as np
import torch

from ..graph import norm_propagator
from ..nn import DiGCN_Inception_Block_node_classification
from ..spectral import appr_directed_adj, second_directed_adj
from ..train import Trainer, masked_nll
from . import _directed_node
from ._common import accuracy, add_device_arg, result, run_steps

propagator = norm_propagator
features = _directed_node.flag_features


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m pytorch_geometric_signed_directed_tpu_torch "
        "digcn_inception_node")
    ap.add_argument("--dataset", default="telegram")
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--dropout", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--weights", choices=("raw", "binary", "log"),
                    default="binary")
    ap.add_argument("--features", choices=("x", "deg"), default="deg")
    add_device_arg(ap)
    return ap


def operator_arrays(args, data, w, n):
    return [appr_directed_adj(args.alpha, data.edge_index, n, w),
            second_directed_adj(data.edge_index, n, w)]


def make_model(args, inputs, split: int
               ) -> DiGCN_Inception_Block_node_classification:
    return DiGCN_Inception_Block_node_classification(
        num_features=int(inputs.x.shape[1]), hidden=args.hidden,
        label_dim=inputs.label_dim, dropout=args.dropout,
        device=inputs.device,
        generator=torch.Generator().manual_seed(args.seed + split))


def make_trainer(args, inputs, split: int, model):
    """The Trainer of split ``split`` (dropout from ``args.dropout``), its
    state over ``model`` and the batch of a step."""
    x, y, (P1, P2) = inputs.x, inputs.y, inputs.ops
    mask = torch.from_numpy(
        inputs.data.train_mask[:, split].astype(np.float32)).to(inputs.device)
    if args.dropout > 0:
        def loss_fn(m, gen, mask):
            return masked_nll(m(x, P1, P2, True, gen), y, mask)
    else:
        def loss_fn(m, mask):
            return masked_nll(m(x, P1, P2), y, mask)
    trainer = Trainer(loss_fn, lr=args.lr,
                      rng=args.seed if args.dropout > 0 else None,
                      device=inputs.device)
    return trainer, trainer.init(model), (mask,)


def train_split(args, inputs, split: int, model=None) -> dict:
    model = make_model(args, inputs, split) if model is None else model
    data = inputs.data
    val_idx = np.nonzero(data.val_mask[:, split])[0]
    test_idx = np.nonzero(data.test_mask[:, split])[0]
    y_np = np.asarray(data.y)
    best = {"val": -1.0, "test": 0.0, "evals": 0}
    eval_every = max(args.epochs // 50, 1)

    def evaluate(epoch):
        if (epoch + 1) % eval_every:
            return
        with torch.no_grad():
            pred = model(inputs.x, *inputs.ops).argmax(1).cpu().numpy()
        best["evals"] += 1
        vacc = accuracy(pred[val_idx], y_np[val_idx])
        if vacc > best["val"]:
            best["val"] = vacc
            best["test"] = accuracy(pred[test_idx], y_np[test_idx])

    run = run_steps(*make_trainer(args, inputs, split, model), args.epochs,
                    evaluate)
    return dict(run, acc=best["test"], val=best["val"], evals=best["evals"])


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    inputs = _directed_node.build_inputs(args, args.device,
                                         sys.modules[__name__])
    runs = []
    for split in range(inputs.data.train_mask.shape[1]):
        r = train_split(args, inputs, split)
        runs.append(r)
        print(f"split {split}: test acc {r['acc']:.4f} (val "
              f"{r['val']:.4f})")
    accs = [r["acc"] for r in runs]
    print(f"mean test acc: {np.mean(accs):.4f} +/- {np.std(accs):.4f}")
    return result(inputs, runs)


if __name__ == "__main__":
    main()
