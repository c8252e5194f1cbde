"""MagNet link prediction (direction / existence / three-class).

Counterpart of ``pytorch_geometric_signed_directed_tpu/experiments/
magnet_link.py``: the same flags, defaults and printed lines, plus
``--device``.  ``build_inputs`` makes the graph and its link splits,
``split_inputs`` the features and Laplacian of one split's observed
graph, ``train_split`` trains it; ``main`` runs them in turn.
"""
import argparse
from types import SimpleNamespace

import numpy as np
import torch

from ..data import DSBM, DirectedData, load_directed_real_data
from ..device import resolve_device
from ..graph import in_out_degree
from ..nn import MagNet_link_prediction
from ..spectral import magnet_operator_arrays, magnetic_pair
from ..train import Trainer
from ..utils import link_class_split, meta_graph_generation
from ._common import StageClock, accuracy, add_device_arg, result, run_steps


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m pytorch_geometric_signed_directed_tpu_torch "
        "magnet_link")
    ap.add_argument("--dataset", default="telegram")
    ap.add_argument("--name", default="telegram")
    ap.add_argument("--task", default="direction",
                    choices=["direction", "existence", "three_class_digraph"])
    ap.add_argument("--epochs", type=int, default=1500)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--K", type=int, default=2)
    ap.add_argument("--q", type=float, default=0.25)
    ap.add_argument("--num_classes", type=int, default=None)
    ap.add_argument("--splits", type=int, default=2)
    ap.add_argument("--num_nodes", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--edge_weights", choices=("binary", "raw", "log"),
                    default="binary",
                    help="transform of the observed-graph edge weights "
                    "(heavy-tailed counts drown the normalized Laplacian)")
    add_device_arg(ap)
    return ap


def get_data(args) -> DirectedData:
    if args.dataset != "synthetic":
        return load_directed_real_data(args.dataset, name=args.name)
    F = meta_graph_generation("path", 3, 0.05, False)
    A, y = DSBM(args.num_nodes, 3, 0.3, F,
                rng=np.random.default_rng(args.seed))
    return DirectedData(A=A, y=y)


def build_inputs(args, device) -> SimpleNamespace:
    """The graph and its ``args.splits`` link splits (numpy), with the host
    seconds of each stage."""
    device = resolve_device(device)
    clock = StageClock(device)
    data = get_data(args)
    clock.mark("graph")
    datasets = link_class_split(data, splits=args.splits, task=args.task,
                                seed=args.seed)
    clock.mark("link_split")
    label_dim = args.num_classes or (3 if args.task == "three_class_digraph"
                                     else 2)
    return SimpleNamespace(data=data, datasets=datasets, label_dim=label_dim,
                           num_edges=data.edge_index.shape[1], device=device,
                           seconds=clock.seconds)


def split_inputs(args, inputs, i: int) -> SimpleNamespace:
    """Degree features and the Laplacian pair of split ``i``'s observed
    graph, and its train/test edges, on the device."""
    device = inputs.device
    clock = StageClock(device)
    ds, n = inputs.datasets[i], inputs.data.num_nodes
    g = ds["graph"]
    w = np.asarray(ds["weights"], np.float32)
    if args.edge_weights == "binary":
        w = np.ones_like(w)
    elif args.edge_weights == "log":
        w = np.log1p(w).astype(np.float32)
    x = in_out_degree(g, n, edge_weight=w)
    x = x / max(x.max(), 1.0)
    clock.mark("features")
    arrays = magnet_operator_arrays(g, w, q=args.q, num_nodes=n)
    clock.mark("laplacian")
    lap = magnetic_pair(*arrays, device=device)
    clock.mark("layout")

    def dev(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    return SimpleNamespace(
        x=dev(x), lap=lap, arrays=arrays[:4], graph_edges=g.shape[1],
        tr_e=dev(ds["train"]["edges"]), tr_y=dev(ds["train"]["label"]),
        te_e=dev(ds["test"]["edges"]), te_y=np.asarray(ds["test"]["label"]),
        device=device, seconds=clock.seconds)


def make_model(args, inputs) -> MagNet_link_prediction:
    return MagNet_link_prediction(
        num_features=2, hidden=args.hidden, K=args.K, q=args.q,
        label_dim=inputs.label_dim, activation=True, device=inputs.device,
        generator=torch.Generator().manual_seed(args.seed))


def make_trainer(args, s: SimpleNamespace, model):
    """The Trainer of split inputs ``s``, its state over ``model`` and the
    (empty) batch of a step."""
    x, lap, tr_e, tr_y = s.x, s.lap, s.tr_e, s.tr_y
    rows = torch.arange(tr_e.shape[0], device=s.device)

    def loss_fn(m):
        return -m(x, x, lap, tr_e)[rows, tr_y].mean()

    trainer = Trainer(loss_fn, lr=args.lr, device=s.device)
    return trainer, trainer.init(model), ()


def train_split(args, inputs, s: SimpleNamespace, model=None) -> dict:
    """``args.epochs`` Adam steps on the train edges of split inputs
    ``s``, then the test accuracy from one forward."""
    model = make_model(args, inputs) if model is None else model
    run = run_steps(*make_trainer(args, s, model), args.epochs)
    with torch.no_grad():
        pred = model(s.x, s.x, s.lap, s.te_e).argmax(1).cpu().numpy()
    return dict(run, acc=accuracy(pred, s.te_y), evals=1,
                host_seconds=s.seconds)


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    inputs = build_inputs(args, args.device)
    runs = []
    for i in inputs.datasets:
        s = split_inputs(args, inputs, i)
        r = train_split(args, inputs, s)
        runs.append(dict(r, split=s))
        print(f"split {i}: test acc {r['acc']:.4f} ({r['seconds']:.1f}s)")
    accs = [r["acc"] for r in runs]
    print(f"mean test acc: {np.mean(accs):.4f} +/- {np.std(accs):.4f}")
    return result(inputs, runs)


if __name__ == "__main__":
    main()
