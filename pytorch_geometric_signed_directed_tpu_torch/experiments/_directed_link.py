"""What the DGCN and DiGCN link experiments share: their flags, the DSBM
graph and its link splits, degree features, training and the printed
lines.  The graph is a DSBM (``--dataset synthetic``) or a real directed
dataset.  Each experiment module supplies ``operator_arrays(args, g, w, n)``
(the host arrays of its operators), ``propagator`` (their builder) and
``make_model(args, inputs)``; its model is called as
``model(x, *operators, query_edges)``."""
import argparse
from types import SimpleNamespace

import numpy as np
import torch

from ..data import DSBM, DirectedData, load_directed_real_data
from ..device import resolve_device
from ..graph import in_out_degree
from ..train import Trainer
from ..utils import link_class_split, meta_graph_generation
from ._common import StageClock, accuracy, add_device_arg, result, run_steps


def parser(name: str, alpha: bool) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog=f"python -m pytorch_geometric_signed_directed_tpu_torch {name}")
    ap.add_argument("--dataset", default="telegram")
    ap.add_argument("--task", default="direction",
                    choices=["direction", "existence", "three_class_digraph"])
    if alpha:
        ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--weight_decay", type=float, default=5e-4)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--splits", type=int, default=2)
    ap.add_argument("--num_nodes", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    return ap


def build_inputs(args, device) -> SimpleNamespace:
    """The graph and its ``args.splits`` link splits (numpy), with the host
    seconds of each stage."""
    device = resolve_device(device)
    clock = StageClock(device)
    if args.dataset == "synthetic":
        F = meta_graph_generation("path", 3, 0.05, False)
        A, y = DSBM(args.num_nodes, 3, 0.3, F,
                    rng=np.random.default_rng(args.seed))
        data = DirectedData(A=A, y=y)
    else:
        data = load_directed_real_data(args.dataset, name=args.dataset)
    clock.mark("graph")
    datasets = link_class_split(data, splits=args.splits, task=args.task,
                                seed=args.seed)
    clock.mark("link_split")
    return SimpleNamespace(
        data=data, datasets=datasets,
        label_dim=3 if args.task == "three_class_digraph" else 2,
        num_edges=data.edge_index.shape[1], device=device,
        seconds=clock.seconds)


def split_inputs(args, inputs, i: int, exp) -> SimpleNamespace:
    """Degree features and the operators of split ``i``'s observed graph,
    and its train/test edges, on the device."""
    device = inputs.device
    clock = StageClock(device)
    ds, n = inputs.datasets[i], inputs.data.num_nodes
    g, w = ds["graph"], ds["weights"]
    x = in_out_degree(g, n, edge_weight=w)
    x = x / max(x.max(), 1.0)
    clock.mark("features")
    arrays = exp.operator_arrays(args, g, w, n)
    clock.mark("operators")
    ops = tuple(exp.propagator(ei, ew, n, device=device) for ei, ew in arrays)
    clock.mark("layout")

    def dev(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    return SimpleNamespace(
        x=dev(x), ops=ops, arrays=arrays, graph_edges=g.shape[1],
        tr_e=dev(ds["train"]["edges"]), tr_y=dev(ds["train"]["label"]),
        te_e=dev(ds["test"]["edges"]), te_y=np.asarray(ds["test"]["label"]),
        device=device, seconds=clock.seconds)


def loss_function(s: SimpleNamespace):
    """``loss(model)``: the mean NLL of split inputs ``s``'s train edges."""
    x, ops, tr_e, tr_y = s.x, s.ops, s.tr_e, s.tr_y
    rows = torch.arange(tr_e.shape[0], device=s.device)

    def loss_fn(m):
        return -m(x, *ops, tr_e)[rows, tr_y].mean()

    return loss_fn


def train_split(args, s: SimpleNamespace, model) -> dict:
    """``args.epochs`` Adam steps (coupled L2 ``args.weight_decay``) on the
    train edges of split inputs ``s``, then the test accuracy from one
    forward."""
    trainer = Trainer(loss_function(s), lr=args.lr,
                      weight_decay=args.weight_decay, device=s.device)
    run = run_steps(trainer, trainer.init(model), (), args.epochs)
    with torch.no_grad():
        pred = model(s.x, *s.ops, s.te_e).argmax(1).cpu().numpy()
    return dict(run, acc=accuracy(pred, s.te_y), evals=1,
                host_seconds=s.seconds)


def main(argv, exp) -> dict:
    args = exp.parser().parse_args(argv)
    inputs = build_inputs(args, args.device)
    runs = []
    for i in inputs.datasets:
        s = split_inputs(args, inputs, i, exp)
        r = train_split(args, s, exp.make_model(args, inputs))
        runs.append(dict(r, split=s))
        print(f"split {i}: test acc {r['acc']:.4f}")
    accs = [r["acc"] for r in runs]
    print(f"mean test acc: {np.mean(accs):.4f} +/- {np.std(accs):.4f}")
    return result(inputs, runs)
