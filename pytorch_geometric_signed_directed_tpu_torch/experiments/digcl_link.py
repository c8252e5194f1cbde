"""DiGCL link prediction: contrastive embeddings and a logistic probe.

Counterpart of ``pytorch_geometric_signed_directed_tpu/experiments/
digcl_link.py``: the same flags, defaults and printed lines, plus
``--device``.  Per link split of a real directed dataset
(``link_class_split``, prob_val 0.15, prob_test 0.05): the unweighted
in/out degrees of the observed graph as features (2 columns), view 1 at
``alpha_1`` and the curriculum's views of that graph (each distinct alpha
built once a split, dense tier), DiGCL hidden 32 / projection 16 /
tau 0.5 trained as in ``digcl_node``, then the one-vs-rest probe on the
train edges' concatenated end embeddings (``utils.pred_digcl_link``).
"""
import argparse
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..data import load_directed_real_data
from ..device import resolve_device
from ..graph import in_out_degree
from ..utils import link_class_split, pred_digcl_link
from ._common import StageClock, accuracy, add_device_arg, result
from .digcl_node import (curriculum_alpha, make_model, print_losses,
                         train_views, view)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m pytorch_geometric_signed_directed_tpu_torch "
        "digcl_link")
    ap.add_argument("--dataset", default="webkb/cornell")
    ap.add_argument("--task", default="direction",
                    choices=["direction", "existence"])
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--proj_hidden", type=int, default=16)
    ap.add_argument("--tau", type=float, default=0.5)
    ap.add_argument("--alpha_1", type=float, default=0.1)
    ap.add_argument("--drop_feature_rate_1", type=float, default=0.3)
    ap.add_argument("--drop_feature_rate_2", type=float, default=0.4)
    ap.add_argument("--weight_decay", type=float, default=5e-4)
    ap.add_argument("--curr_type", default="log",
                    choices=["linear", "exp", "log", "fixed"])
    ap.add_argument("--splits", type=int, default=2,
                    help="number of link splits")
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    return ap


def build_inputs(args, device) -> SimpleNamespace:
    """The dataset (``name/subname`` for WebKB and WikipediaNetwork) and
    its link splits, with the host seconds of each stage."""
    device = resolve_device(device)
    clock = StageClock(device)
    if "/" in args.dataset:
        ds, name = args.dataset.split("/")
    else:
        ds = name = args.dataset
    data = load_directed_real_data(ds, name=name)
    clock.mark("load")
    datasets = link_class_split(data, splits=args.splits, prob_val=0.15,
                                prob_test=0.05, task=args.task,
                                seed=args.seed)
    clock.mark("link_split")
    return SimpleNamespace(
        data=data, n=data.num_nodes, datasets=datasets,
        num_edges=data.edge_index.shape[1], device=device,
        drop=torch.Generator(device=device).manual_seed(args.seed),
        seconds=clock.seconds)


def split_inputs(args, inputs, split: int) -> SimpleNamespace:
    """Split ``split``'s observed graph: its degree features, view 1 and
    its curriculum's views (a cache of its own)."""
    ds = inputs.datasets[split]
    g, w = ds["graph"], ds["weights"]
    t0 = time.perf_counter()
    # unweighted degrees, as the JAX experiment (in_channels = 2)
    x = torch.from_numpy(np.asarray(in_out_degree(g, inputs.n), np.float32))
    cache = {}
    P1 = view(inputs, g, w, args.alpha_1, {})
    views = [view(inputs, g, w,
                  curriculum_alpha(args.curr_type, e, args.epochs), cache)
             for e in range(args.epochs)]
    return SimpleNamespace(x=x.to(inputs.device), P1=P1, views=views,
                           cache=cache, graph_edges=g.shape[1],
                           seconds=time.perf_counter() - t0)


def train_split(args, inputs, split: int, model=None) -> dict:
    s = split_inputs(args, inputs, split)
    if model is None:
        model = make_model(args, 2, inputs.device, split, "relu")
    run = train_views(args, s.x, s.P1, s.views, inputs.drop, inputs.device,
                      model)
    t0 = time.perf_counter()
    with torch.no_grad():
        z = model(s.x, s.P1).cpu().numpy()
    ds = inputs.datasets[split]
    te_y = np.asarray(ds["test"]["label"])
    pred = pred_digcl_link(z, np.asarray(ds["train"]["label"]),
                           np.asarray(ds["train"]["edges"]),
                           np.asarray(ds["test"]["edges"]))
    return dict(run, acc=accuracy(pred, te_y), evals=1, split=s,
                host_seconds={"views": s.seconds,
                              "probe": time.perf_counter() - t0})


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    inputs = build_inputs(args, args.device)
    runs = []
    for split in range(args.splits):
        r = train_split(args, inputs, split)
        runs.append(r)
        print_losses(split, r["losses"])
        print(f"split {split}: logistic test acc {r['acc']:.4f}")
    accs = np.asarray([r["acc"] for r in runs])
    print(f"{args.dataset} DiGCL {args.task} ({args.curr_type}): "
          f"acc {accs.mean():.4f} +/- {accs.std():.4f} over {len(accs)} "
          f"splits")
    return result(inputs, runs)


if __name__ == "__main__":
    main()
