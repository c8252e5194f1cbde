"""MSGNN signed-directed link tasks (4/5-class sign+direction, sign).

Counterpart of ``pytorch_geometric_signed_directed_tpu/experiments/
msgnn_link.py``: the same flags, defaults and printed line, plus
``--device``.  ``build_inputs`` makes the graph, its one link split, the
features and the signed Laplacian of the observed graph; ``train_split``
trains; ``main`` runs both.  As in the JAX experiment the model is called
without ``training``, so its dropout is off.
"""
import argparse
from types import SimpleNamespace

import numpy as np
import torch

from ..data import SDSBM, SignedData, load_signed_real_data
from ..device import resolve_device
from ..graph import in_out_degree
from ..nn import MSGNN_link_prediction
from ..spectral import magnet_operator_arrays, magnetic_pair
from ..train import Trainer
from ..utils import link_class_split, meta_graph_generation
from ._common import StageClock, accuracy, add_device_arg, result, run_steps

LABEL_DIM = {"four_class_signed_digraph": 4, "five_class_signed_digraph": 5,
             "sign": 2}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m pytorch_geometric_signed_directed_tpu_torch "
        "msgnn_link")
    ap.add_argument("--dataset", default="bitcoin_alpha")
    ap.add_argument("--task", default="four_class_signed_digraph",
                    choices=["four_class_signed_digraph",
                             "five_class_signed_digraph", "sign"])
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--lr", type=float, default=1e-2)
    # the JAX package's sweep-tuned defaults: pos/neg-separated degree
    # features ("sd4"), q=0, K=1, hidden 64
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--K", type=int, default=1)
    ap.add_argument("--q", type=float, default=0.0)
    ap.add_argument("--features", choices=("sd4", "w4", "uw2"),
                    default="sd4")
    ap.add_argument("--num_nodes", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    # thresholding of the dense lead-lag matrices of the real datasets
    ap.add_argument("--sparsify_level", type=float, default=1.0)
    add_device_arg(ap)
    return ap


def build_inputs(args, device) -> SimpleNamespace:
    """Signed graph, its one link split, the observed graph's features and
    signed Laplacian pair on ``device``, and the train/test edges, with
    the host seconds of each stage."""
    device = resolve_device(device)
    clock = StageClock(device)
    if args.dataset == "synthetic":
        F = meta_graph_generation("cyclic", 3, 0.05, False)
        F[0, 1] = -abs(F[0, 1])
        A, y = SDSBM(args.num_nodes, 3, 0.1, F, eta=0.1,
                     rng=np.random.default_rng(args.seed))
        data = SignedData(A=A, y=y)
    else:
        data = load_signed_real_data(args.dataset,
                                     sparsify_level=args.sparsify_level)
    clock.mark("graph")
    n = data.num_nodes
    datasets = link_class_split(data, splits=1, task=args.task,
                                seed=args.seed, maintain_connect=False)
    clock.mark("link_split")
    g, w = datasets[0]["graph"], datasets[0]["weights"]
    if args.features == "sd4":
        # pos/neg-separated unweighted degrees
        d = SignedData(edge_index=np.asarray(g), edge_weight=np.asarray(w))
        d.separate_positive_negative()
        x = np.concatenate([in_out_degree(d.edge_index_p, n),
                            in_out_degree(d.edge_index_n, n)], axis=1)
    elif args.features == "uw2":
        x = in_out_degree(g, n)
    else:
        x = in_out_degree(g, n, signed=True, edge_weight=w)
    x = np.asarray(x, np.float32)
    x = x / max(np.abs(x).max(), 1.0)
    clock.mark("features")
    arrays = magnet_operator_arrays(g, w, q=args.q, num_nodes=n, signed=True)
    clock.mark("laplacian")
    lap = magnetic_pair(*arrays, device=device)
    clock.mark("layout")

    def dev(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    ds = datasets[0]
    return SimpleNamespace(
        data=data, datasets=datasets, x=dev(x), lap=lap, arrays=arrays[:4],
        graph_edges=g.shape[1], tr_e=dev(ds["train"]["edges"]),
        tr_y=dev(ds["train"]["label"]), te_e=dev(ds["test"]["edges"]),
        te_y=np.asarray(ds["test"]["label"]), label_dim=LABEL_DIM[args.task],
        num_edges=data.edge_index.shape[1], device=device,
        seconds=clock.seconds)


def make_model(args, inputs) -> MSGNN_link_prediction:
    return MSGNN_link_prediction(
        num_features=int(inputs.x.shape[1]), hidden=args.hidden, K=args.K,
        q=args.q, label_dim=inputs.label_dim, device=inputs.device,
        generator=torch.Generator().manual_seed(args.seed))


def make_trainer(args, inputs, model):
    """The Trainer, its state over ``model`` and the (empty) batch of a
    step."""
    x, lap, tr_e, tr_y = inputs.x, inputs.lap, inputs.tr_e, inputs.tr_y
    rows = torch.arange(tr_e.shape[0], device=inputs.device)

    def loss_fn(m):
        return -m(x, x, lap, tr_e)[0][rows, tr_y].mean()

    trainer = Trainer(loss_fn, lr=args.lr, device=inputs.device)
    return trainer, trainer.init(model), ()


def train_split(args, inputs, model=None) -> dict:
    """``args.epochs`` Adam steps on the train edges, then the test
    accuracy from one forward."""
    model = make_model(args, inputs) if model is None else model
    run = run_steps(*make_trainer(args, inputs, model), args.epochs)
    x, lap = inputs.x, inputs.lap
    with torch.no_grad():
        pred = model(x, x, lap, inputs.te_e)[0].argmax(1).cpu().numpy()
    return dict(run, acc=accuracy(pred, inputs.te_y), evals=1)


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    inputs = build_inputs(args, args.device)
    r = train_split(args, inputs)
    print(f"{args.task} test acc: {r['acc']:.4f} ({r['seconds']:.1f}s)")
    return result(inputs, [r])


if __name__ == "__main__":
    main()
