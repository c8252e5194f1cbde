"""MagNet node classification (``--dataset synthetic`` or a real directed
dataset).

Counterpart of ``pytorch_geometric_signed_directed_tpu/experiments/
magnet_node.py``: the same flags, defaults and printed lines, plus
``--device``.  ``build_inputs`` is the host part (graph, node splits,
features, Laplacian and its layout on the device), ``train_split`` trains
one split (the step is ``make_trainer``'s); ``main`` runs both.
"""
import argparse
from types import SimpleNamespace

import numpy as np
import torch

from ..data import DSBM, DirectedData, load_directed_real_data
from ..device import resolve_device
from ..graph import in_out_degree
from ..nn import MagNet_node_classification
from ..spectral import magnet_operator_arrays, magnetic_pair
from ..train import Trainer, masked_nll
from ..utils import meta_graph_generation
from ._common import StageClock, accuracy, add_device_arg, result, run_steps


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m pytorch_geometric_signed_directed_tpu_torch "
        "magnet_node")
    ap.add_argument("--dataset", default="telegram")
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--weight_decay", type=float, default=5e-4)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--K", type=int, default=2)
    ap.add_argument("--q", type=float, default=0.2)
    ap.add_argument("--dropout", type=float, default=0.5)
    ap.add_argument("--features", choices=("degree", "data"),
                    default="degree",
                    help="degree: in/out-degree (MagNet-paper style); "
                    "data: the dataset's own x (reference-example style)")
    ap.add_argument("--normalize_features", action="store_true",
                    help="row-normalize x to sum 1 (standard for BOW)")
    ap.add_argument("--edge_weights", choices=("binary", "raw", "log"),
                    default="binary",
                    help="transform of the edge weights used for both the "
                    "Laplacian and the degree features")
    ap.add_argument("--num_nodes", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    return ap


def build_inputs(args, device) -> SimpleNamespace:
    """Graph, node splits, features and the Laplacian pair on ``device``,
    with the host seconds of each stage."""
    device = resolve_device(device)
    clock = StageClock(device)
    if args.dataset == "synthetic":
        F = meta_graph_generation("cyclic", 5, 0.05, False)
        A, y = DSBM(args.num_nodes, 5, 0.3, F,
                    rng=np.random.default_rng(args.seed))
        data = DirectedData(A=A, y=y)
        data.node_split(train_size_per_class=0.6, val_size_per_class=0.2,
                        data_split=2)
    else:
        data = load_directed_real_data(args.dataset, name=args.dataset)
    clock.mark("graph")

    n = data.num_nodes
    w = np.asarray(data.edge_weight, np.float32)
    if args.edge_weights == "binary":
        w = np.ones_like(w)
    elif args.edge_weights == "log":
        w = np.log1p(w).astype(np.float32)
    if args.features == "data" and getattr(data, "x", None) is not None:
        x = np.asarray(data.x, np.float32)
        if args.normalize_features:
            x = x / np.maximum(x.sum(1, keepdims=True), 1e-12)
    else:
        x = in_out_degree(data.edge_index, n, edge_weight=w)
        x = x / max(x.max(), 1.0)
    clock.mark("features")
    arrays = magnet_operator_arrays(data.edge_index, w, q=args.q,
                                    num_nodes=n)
    clock.mark("laplacian")
    lap = magnetic_pair(*arrays, device=device)
    clock.mark("layout")
    return SimpleNamespace(
        data=data, x=torch.from_numpy(x).to(device),
        y=torch.from_numpy(np.asarray(data.y)).to(device), lap=lap,
        arrays=arrays[:4], label_dim=int(np.asarray(data.y).max()) + 1,
        num_edges=data.edge_index.shape[1], device=device,
        seconds=clock.seconds)


def make_model(args, inputs, split: int) -> MagNet_node_classification:
    return MagNet_node_classification(
        num_features=int(inputs.x.shape[1]), hidden=args.hidden, K=args.K,
        q=args.q, label_dim=inputs.label_dim, activation=True,
        dropout=args.dropout, device=inputs.device,
        generator=torch.Generator().manual_seed(args.seed + split))


def make_trainer(args, inputs, split: int, model):
    """The Trainer of split ``split`` (dropout from ``args.dropout``,
    drawn from a generator seeded ``args.seed``), its state over
    ``model`` and the batch of a step."""
    x, y, lap = inputs.x, inputs.y, inputs.lap
    train_mask = torch.from_numpy(
        inputs.data.train_mask[:, split].astype(np.float32)).to(inputs.device)

    if args.dropout > 0:
        def loss_fn(m, gen, mask):
            return masked_nll(m(x, x, lap, True, gen), y, mask)
    else:
        def loss_fn(m, mask):
            return masked_nll(m(x, x, lap), y, mask)

    trainer = Trainer(loss_fn, lr=args.lr, weight_decay=args.weight_decay,
                      rng=args.seed if args.dropout > 0 else None,
                      device=inputs.device)
    return trainer, trainer.init(model), (train_mask,)


def train_split(args, inputs, split: int, model=None) -> dict:
    """Train split ``split`` for ``args.epochs`` steps, evaluating every
    ``epochs // 50`` steps with one forward; the test accuracy is that of
    the best validation accuracy."""
    model = make_model(args, inputs, split) if model is None else model
    x, lap, data = inputs.x, inputs.lap, inputs.data
    val_idx = np.nonzero(data.val_mask[:, split])[0]
    test_idx = np.nonzero(data.test_mask[:, split])[0]
    y_np = np.asarray(data.y)
    trainer, state, batch = make_trainer(args, inputs, split, model)
    best = {"val": -1.0, "test": 0.0, "evals": 0}
    eval_every = max(args.epochs // 50, 1)

    def evaluate(epoch):
        if (epoch + 1) % eval_every:
            return
        with torch.no_grad():
            pred = model(x, x, lap).argmax(1).cpu().numpy()
        best["evals"] += 1
        vacc = accuracy(pred[val_idx], y_np[val_idx])
        if vacc > best["val"]:
            best["val"] = vacc
            best["test"] = accuracy(pred[test_idx], y_np[test_idx])

    run = run_steps(trainer, state, batch, args.epochs, evaluate)
    return dict(run, acc=best["test"], val=best["val"],
                evals=best["evals"])


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    inputs = build_inputs(args, args.device)
    runs = []
    for split in range(inputs.data.train_mask.shape[1]):
        r = train_split(args, inputs, split)
        runs.append(r)
        print(f"split {split}: test acc {r['acc']:.4f} (val {r['val']:.4f})")
    accs = [r["acc"] for r in runs]
    print(f"mean test acc: {np.mean(accs):.4f} +/- {np.std(accs):.4f}")
    return result(inputs, runs)


if __name__ == "__main__":
    main()
