"""MSGNN node classification on signed directed graphs (SDSBM or a real
signed dataset).

Counterpart of ``pytorch_geometric_signed_directed_tpu/experiments/
msgnn_node.py``: the same flags, defaults and printed lines, plus
``--device``.  ``build_inputs`` is the host part, ``train_split`` trains
one split; ``main`` runs both.  As in the JAX experiment the model is
called without ``training``, so its dropout is off.
"""
import argparse
from types import SimpleNamespace

import numpy as np
import torch

from ..data import SDSBM, SignedData, load_signed_real_data
from ..device import resolve_device
from ..graph import in_out_degree
from ..nn import MSGNN_node_classification
from ..spectral import magnet_operator_arrays, magnetic_pair
from ..train import Trainer, masked_nll
from ..utils import meta_graph_generation
from ._common import StageClock, accuracy, add_device_arg, result, run_steps


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m pytorch_geometric_signed_directed_tpu_torch "
        "msgnn_node")
    ap.add_argument("--dataset", default="synthetic")
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--weight_decay", type=float, default=5e-4)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--K", type=int, default=1)
    ap.add_argument("--q", type=float, default=0.25)
    ap.add_argument("--num_nodes", type=int, default=1000)
    ap.add_argument("--eta", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    return ap


def build_inputs(args, device) -> SimpleNamespace:
    """Signed graph, node splits, signed degree features and the signed
    Laplacian pair on ``device``, with the host seconds of each stage."""
    device = resolve_device(device)
    clock = StageClock(device)
    if args.dataset == "synthetic":
        F = meta_graph_generation("cyclic", 3, 0.05, False)
        F[0, 1] = -abs(F[0, 1])
        F[1, 0] = -abs(F[1, 0])
        A, y = SDSBM(args.num_nodes, 3, 0.1, F, eta=args.eta,
                     rng=np.random.default_rng(args.seed))
        data = SignedData(A=A, y=y)
    else:
        # a dataset without node labels fails in node_split, as in the
        # JAX experiment
        data = load_signed_real_data(args.dataset)
    data.node_split(train_size_per_class=0.6, val_size_per_class=0.2,
                    data_split=2)
    clock.mark("graph")
    n = data.num_nodes
    x = in_out_degree(data.edge_index, n, signed=True,
                      edge_weight=data.edge_weight)
    x = x / max(np.abs(x).max(), 1.0)
    clock.mark("features")
    arrays = magnet_operator_arrays(data.edge_index, data.edge_weight,
                                    q=args.q, num_nodes=n, signed=True)
    clock.mark("laplacian")
    lap = magnetic_pair(*arrays, device=device)
    clock.mark("layout")
    return SimpleNamespace(
        data=data, x=torch.from_numpy(x).to(device),
        y=torch.from_numpy(np.asarray(data.y)).to(device), lap=lap,
        arrays=arrays[:4], label_dim=int(np.asarray(data.y).max()) + 1,
        num_edges=data.edge_index.shape[1], device=device,
        seconds=clock.seconds)


def make_model(args, inputs, split: int) -> MSGNN_node_classification:
    return MSGNN_node_classification(
        num_features=4, hidden=args.hidden, K=args.K, q=args.q,
        label_dim=inputs.label_dim, device=inputs.device,
        generator=torch.Generator().manual_seed(args.seed + split))


def make_trainer(args, inputs, split: int, model):
    """The Trainer of split ``split``, its state over ``model`` and the
    batch of a step."""
    x, y, lap = inputs.x, inputs.y, inputs.lap
    train_mask = torch.from_numpy(
        inputs.data.train_mask[:, split].astype(np.float32)).to(inputs.device)

    def loss_fn(m, mask):
        return masked_nll(m(x, x, lap)[1], y, mask)

    trainer = Trainer(loss_fn, lr=args.lr, weight_decay=args.weight_decay,
                      device=inputs.device)
    return trainer, trainer.init(model), (train_mask,)


def train_split(args, inputs, split: int, model=None) -> dict:
    """``args.epochs`` Adam steps on split ``split``'s train nodes, then
    the test accuracy from one forward."""
    model = make_model(args, inputs, split) if model is None else model
    x, lap, data = inputs.x, inputs.lap, inputs.data
    test_idx = np.nonzero(data.test_mask[:, split])[0]
    run = run_steps(*make_trainer(args, inputs, split, model), args.epochs)
    with torch.no_grad():
        pred = model(x, x, lap)[1].argmax(1).cpu().numpy()
    return dict(run, acc=accuracy(pred[test_idx],
                                  np.asarray(data.y)[test_idx]), evals=1)


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    inputs = build_inputs(args, args.device)
    runs = []
    for split in range(inputs.data.train_mask.shape[1]):
        r = train_split(args, inputs, split)
        runs.append(r)
        print(f"split {split}: test acc {r['acc']:.4f}")
    accs = [r["acc"] for r in runs]
    print(f"mean test acc: {np.mean(accs):.4f} +/- {np.std(accs):.4f}")
    return result(inputs, runs)


if __name__ == "__main__":
    main()
