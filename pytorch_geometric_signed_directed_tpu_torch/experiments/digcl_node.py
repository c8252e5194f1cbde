"""DiGCL contrastive node embedding, evaluated by a logistic probe.

Counterpart of ``pytorch_geometric_signed_directed_tpu/experiments/
digcl_node.py``: the same flags, defaults and printed lines, plus
``--device``.  Two graph views of a real directed dataset
(``spectral.cal_fast_appr``): view 1 at ``alpha_1``, view 2 at the alpha
of an epoch's curriculum (a = 0.9, b = 0.1; the ``log`` schedule starts
at 1.7 and decays towards 0.89, so it visits alpha > 1), both
GCN-normalized on the dense tier; column dropout of the features in each
view, the InfoNCE loss, Adam with coupled L2; then the frozen embedding's
one-vs-rest logistic probe (``utils.pred_digcl_node``) on each split.

``build_inputs`` loads the data and builds view 1; ``view`` builds or
reuses the view of an alpha (one dense operator per distinct alpha,
shared by the splits, as the JAX experiment caches them);
``train_split`` trains one split and probes it; ``main`` runs them.
"""
import argparse
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..data import load_directed_real_data
from ..device import resolve_device
from ..graph import gcn_norm_propagator, in_out_degree
from ..nn import DiGCL
from ..spectral import cal_fast_appr
from ..train import Trainer
from ..utils import drop_feature, pred_digcl_node
from ._common import StageClock, accuracy, add_device_arg, result, run_steps


def curriculum_alpha(curr_type: str, epoch: int, num_epochs: int) -> float:
    """alpha_2 at ``epoch``: a = 0.9, b = 0.1; the ``log`` schedule spans
    [~0.89, 1.7]."""
    a, b = 0.9, 0.1
    if curr_type == "linear":
        return float(a - (a - b) / (num_epochs + 1) * epoch)
    if curr_type == "exp":
        return float(a - (a - b) / (np.exp(3) - 1) * (
            np.exp(3 * epoch / (num_epochs + 1)) - 1))
    if curr_type == "log":
        return float(a - (a - b) * (1 / 3 * np.log(
            epoch / (num_epochs + 1) + np.exp(-3))))
    return 0.9  # fixed


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m pytorch_geometric_signed_directed_tpu_torch "
        "digcl_node")
    ap.add_argument("--dataset", default="cora_ml")
    ap.add_argument("--alpha_1", type=float, default=0.1)
    ap.add_argument("--drop_feature_rate_1", type=float, default=0.3)
    ap.add_argument("--drop_feature_rate_2", type=float, default=0.4)
    ap.add_argument("--weight_decay", type=float, default=5e-4)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--proj_hidden", type=int, default=32)
    ap.add_argument("--tau", type=float, default=0.4)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--curr_type", default="log",
                    choices=["linear", "exp", "log", "fixed"])
    ap.add_argument("--activation", default="relu")
    ap.add_argument("--splits", type=int, default=0,
                    help="cap on the number of mask splits (0 = all)")
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    return ap


def view(inputs, edge_index, edge_weight, alpha: float, cache: dict):
    """The GCN-normalized dense operator of the PPR view at ``alpha``,
    built once per distinct alpha into ``cache``."""
    if alpha not in cache:
        ei, w = cal_fast_appr(alpha, edge_index, inputs.n, edge_weight)
        cache[alpha] = gcn_norm_propagator(ei, w, inputs.n, mode="dense",
                                           device=inputs.device)
    return cache[alpha]


def build_inputs(args, device) -> SimpleNamespace:
    """The dataset, its features and view 1 on ``device``, with the host
    seconds of each stage."""
    device = resolve_device(device)
    clock = StageClock(device)
    data = load_directed_real_data(args.dataset, name=args.dataset)
    clock.mark("load")
    n = data.num_nodes
    if data.x is not None:
        x = np.asarray(data.x, np.float32)
    else:
        x = in_out_degree(data.edge_index, n, edge_weight=data.edge_weight)
    clock.mark("features")
    inputs = SimpleNamespace(
        data=data, n=n, x=torch.from_numpy(x).to(device), views={},
        num_edges=data.edge_index.shape[1], device=device,
        drop=torch.Generator(device=device).manual_seed(args.seed),
        seconds=clock.seconds)
    inputs.P1 = view(inputs, data.edge_index, data.edge_weight, args.alpha_1,
                     {})
    clock.mark("views")
    return inputs


def make_model(args, in_channels: int, device, split: int,
               activation: str) -> DiGCL:
    return DiGCL(in_channels=in_channels, activation=activation,
                 num_hidden=args.hidden, num_proj_hidden=args.proj_hidden,
                 tau=args.tau, num_layers=2, device=device,
                 generator=torch.Generator().manual_seed(args.seed + split))


def loss_function(P1):
    """``loss(model, x1, x2, P2)``: DiGCL's InfoNCE loss between view 1 of
    x1 and view P2 of x2."""

    def loss_fn(m, x1, x2, P2):
        return m.loss(m(x1, P1), m(x2, P2))

    return loss_fn


def train_views(args, x, P1, views, drop, device, model) -> dict:
    """``args.epochs`` Adam steps (coupled L2) of ``model``: epoch e's
    batch is x with columns dropped at the two rates (from generator
    ``drop``) and ``views[e]``."""
    trainer = Trainer(loss_function(P1), lr=args.lr,
                      weight_decay=args.weight_decay, device=device)

    def batch(epoch):
        return (drop_feature(x, args.drop_feature_rate_1, drop),
                drop_feature(x, args.drop_feature_rate_2, drop),
                views[epoch])

    return run_steps(trainer, trainer.init(model), batch, args.epochs)


def print_losses(split: int, losses) -> None:
    for epoch in range(49, len(losses), 50):
        print(f"split {split} epoch {epoch + 1}: loss {losses[epoch]:.4f}")


def train_split(args, inputs, split: int, model=None) -> dict:
    """Train on split ``split`` (the views of the curriculum built first),
    then probe the frozen embedding on its train and test nodes."""
    if model is None:
        model = make_model(args, int(inputs.x.shape[1]), inputs.device,
                           split, args.activation)
    data = inputs.data
    t0 = time.perf_counter()
    views = [view(inputs, data.edge_index, data.edge_weight,
                  curriculum_alpha(args.curr_type, e, args.epochs),
                  inputs.views) for e in range(args.epochs)]
    built = time.perf_counter() - t0
    run = train_views(args, inputs.x, inputs.P1, views, inputs.drop,
                      inputs.device, model)
    t0 = time.perf_counter()
    with torch.no_grad():
        z = model(inputs.x, inputs.P1).cpu().numpy()
    y = np.asarray(data.y)
    train_idx = np.nonzero(data.train_mask[:, split])[0]
    test_idx = np.nonzero(data.test_mask[:, split])[0]
    pred = pred_digcl_node(z, y, train_idx, test_idx)
    return dict(run, acc=accuracy(pred, y[test_idx]), evals=1,
                host_seconds={"views": built,
                              "probe": time.perf_counter() - t0})


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    inputs = build_inputs(args, args.device)
    n_splits = inputs.data.train_mask.shape[1]
    if args.splits:
        n_splits = min(n_splits, args.splits)
    runs = []
    for split in range(n_splits):
        r = train_split(args, inputs, split)
        runs.append(r)
        print_losses(split, r["losses"])
        print(f"split {split}: logistic test acc {r['acc']:.4f}")
    accs = np.asarray([r["acc"] for r in runs])
    print(f"{args.dataset} DiGCL ({args.curr_type}): "
          f"acc {accs.mean():.4f} +/- {accs.std():.4f} over {len(accs)} "
          f"splits")
    return result(inputs, runs)


if __name__ == "__main__":
    main()
