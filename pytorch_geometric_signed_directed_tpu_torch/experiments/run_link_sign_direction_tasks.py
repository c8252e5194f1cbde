"""Joint link sign and direction tasks (4/5-class signed digraph splits).

Counterpart of ``pytorch_geometric_signed_directed_tpu/experiments/
run_link_sign_direction_tasks.py``: the same flags, defaults and printed
lines, plus ``--device``.  ``--method`` sgcn / snea / sigat / sdgnn trains
an embedding model on its own loss (AdamW) and probes the query edges
with a multinomial logistic regression; msgnn and sssnet train end to
end on the NLL of the query edges.  ``--dataset synthetic`` is an SDSBM
graph of ``--num_nodes``; ``--direction_only`` halves the labels.
Reached as a module, as in the JAX package (``examples/``); it is not a
registry name.
"""
import argparse
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..data import SDSBM, SignedData, load_signed_real_data
from ..device import resolve_device
from ..graph import in_out_degree, rw_norm_propagator
from ..nn import MSGNN_link_prediction, SSSNET_link_prediction
from ..spectral import magnet_propagators
from ..train import Trainer
from ..utils import (link_class_split,
                     link_sign_direction_prediction_logistic_function,
                     meta_graph_generation)
from ..utils.general.logistic import accuracy_score, f1_score
from ._common import StageClock, add_device_arg, result, run_steps
from ._signed_embedding import (EMBEDDING_METHODS, embedding_model,
                                train_embedding)

TASKS = {4: "four_class_signed_digraph", 5: "five_class_signed_digraph"}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m pytorch_geometric_signed_directed_tpu_torch."
        "experiments.run_link_sign_direction_tasks")
    ap.add_argument("--dataset", default="bitcoin_alpha")
    ap.add_argument("--method", default="msgnn",
                    choices=EMBEDDING_METHODS + ("msgnn", "sssnet"))
    ap.add_argument("--num_classes", type=int, default=4, choices=(4, 5))
    ap.add_argument("--direction_only", action="store_true",
                    help="degrade to direction-only labels (y // 2)")
    ap.add_argument("--runs", type=int, default=5,
                    help="number of link splits")
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--weight_decay", type=float, default=5e-4)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--in_dim", type=int, default=20)
    ap.add_argument("--out_dim", type=int, default=20)
    ap.add_argument("--K", type=int, default=1)
    ap.add_argument("--q", type=float, default=0.0)
    ap.add_argument("--hop", type=int, default=2)
    ap.add_argument("--tau", type=float, default=0.5)
    ap.add_argument("--features", choices=("sd4", "w4", "uw2"),
                    default="sd4")
    ap.add_argument("--train_ratio", type=float, default=0.8)
    ap.add_argument("--num_nodes", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    return ap


def degree_features(g, w, n, kind) -> np.ndarray:
    """The end-to-end methods' input: ``sd4`` pos/neg-separated unweighted
    in/out degrees, ``uw2`` unweighted, ``w4`` signed weighted; over the
    largest magnitude."""
    if kind == "sd4":
        d = SignedData(edge_index=np.asarray(g), edge_weight=np.asarray(w))
        d.separate_positive_negative()
        x = np.concatenate([in_out_degree(d.edge_index_p, n),
                            in_out_degree(d.edge_index_n, n)], axis=1)
    elif kind == "uw2":
        x = in_out_degree(g, n)
    else:
        x = in_out_degree(g, n, signed=True, edge_weight=w)
    x = np.asarray(x, np.float32)
    return x / max(np.abs(x).max(), 1.0)


def build_inputs(args, device) -> SimpleNamespace:
    """The signed graph and its ``--runs`` link splits, with the host
    seconds of each stage."""
    device = resolve_device(device)
    clock = StageClock(device)
    task = TASKS[args.num_classes]
    if args.dataset == "synthetic":
        F = meta_graph_generation("cyclic", 3, 0.05, False)
        F[0, 1] = -abs(F[0, 1])
        A, y = SDSBM(args.num_nodes, 3, 0.1, F, eta=0.1,
                     rng=np.random.default_rng(args.seed))
        data = SignedData(A=A, y=y)
    else:
        data = load_signed_real_data(args.dataset)
    clock.mark("graph")
    link_data = link_class_split(
        data, splits=args.runs, task=task, prob_val=0.0,
        prob_test=1.0 - args.train_ratio, seed=args.seed)
    clock.mark("link_split")
    return SimpleNamespace(
        data=data, n=data.num_nodes, link_data=link_data, task=task,
        num_classes=args.num_classes - 2 * args.direction_only,
        num_edges=data.edge_index.shape[1], device=device,
        seconds=clock.seconds)


def end_to_end(args, inputs, g, w, tr_e, tr_y, te_e):
    """The MSGNN or SSSNET model of one split with its loss and its
    prediction of the test edges."""
    n, device = inputs.n, inputs.device
    x = torch.from_numpy(degree_features(g, w, n, args.features)).to(device)

    def dev(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    tr_e, tr_y, te_e = dev(tr_e), dev(tr_y), dev(te_e)
    rows = torch.arange(tr_e.shape[0], device=device)
    gen = torch.Generator().manual_seed(args.seed)
    if args.method == "msgnn":
        lap = magnet_propagators(g, w, q=args.q, num_nodes=n, signed=True,
                                 device=device)
        model = MSGNN_link_prediction(
            num_features=int(x.shape[1]), hidden=args.hidden, K=args.K,
            q=args.q, label_dim=inputs.num_classes, device=device,
            generator=gen)

        def forward(m, edges):
            return m(x, x, lap, edges)[0]
    else:
        d1 = SignedData(edge_index=g, edge_weight=w)
        d1.separate_positive_negative()
        directed = bool(d1.is_directed)
        P_p = rw_norm_propagator(d1.edge_index_p, d1.edge_weight_p, n,
                                 fill_value=args.tau, device=device)
        P_n = rw_norm_propagator(d1.edge_index_n, d1.edge_weight_n, n,
                                 fill_value=0.0, device=device)
        P_pt = P_nt = None
        if directed:
            P_pt = rw_norm_propagator(d1.edge_index_p[[1, 0]],
                                      d1.edge_weight_p, n,
                                      fill_value=args.tau, device=device)
            P_nt = rw_norm_propagator(d1.edge_index_n[[1, 0]],
                                      d1.edge_weight_n, n, fill_value=0.0,
                                      device=device)
        model = SSSNET_link_prediction(
            nfeat=int(x.shape[1]), hidden=args.hidden,
            nclass=inputs.num_classes, hop=args.hop, fill_value=args.tau,
            directed=directed, device=device, generator=gen)

        def forward(m, edges):
            return m(P_p, P_n, x, edges, P_pt, P_nt)

    def loss_fn(m):
        return -forward(m, tr_e)[rows, tr_y].mean()

    return model, loss_fn, lambda m: forward(m, te_e)


def run_split(args, inputs, split: int) -> dict:
    ld = inputs.link_data[split]
    g, w = np.asarray(ld["graph"]), np.asarray(ld["weights"])
    tr_e = np.asarray(ld["train"]["edges"])
    tr_y = np.asarray(ld["train"]["label"])
    te_e = np.asarray(ld["test"]["edges"])
    te_y = np.asarray(ld["test"]["label"])
    if args.direction_only:
        tr_y, te_y = tr_y // 2, te_y // 2
    t0 = time.perf_counter()
    if args.method in EMBEDDING_METHODS:
        edge_index_s = np.concatenate(
            [g.T, np.where(w > 0, 1, -1)[:, None].astype(np.int64)], axis=1)
        emb = embedding_model(args.method, inputs.n, edge_index_s,
                              args.in_dim, args.out_dim, args.seed,
                              inputs.device, lamb=5.0)
        prep = time.perf_counter() - t0
        r = train_embedding(emb, args.epochs, args.lr, args.weight_decay,
                            inputs.device)
        t0 = time.perf_counter()
        metrics = link_sign_direction_prediction_logistic_function(
            r["z"], tr_e, tr_y, te_e, te_y)
        probe = time.perf_counter() - t0
    else:
        model, loss_fn, predict = end_to_end(args, inputs, g, w, tr_e, tr_y,
                                             te_e)
        prep = time.perf_counter() - t0
        trainer = Trainer(loss_fn, lr=args.lr,
                          weight_decay=args.weight_decay,
                          device=inputs.device)
        r = run_steps(trainer, trainer.init(model), (), args.epochs)
        t0 = time.perf_counter()
        with torch.no_grad():
            pred = predict(model).argmax(1).cpu().numpy()
        metrics = (accuracy_score(te_y, pred),
                   f1_score(te_y, pred, average="macro"),
                   f1_score(te_y, pred, average="micro"))
        probe = time.perf_counter() - t0
    return dict(r, acc=metrics[0], metrics=metrics, evals=1,
                host_seconds={"operators": prep, "probe": probe})


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    inputs = build_inputs(args, args.device)
    runs = []
    for split in range(args.runs):
        r = run_split(args, inputs, split)
        runs.append(r)
        acc, f1_macro, f1_micro = r["metrics"]
        print(f"split {split}: acc {acc:.4f} macro-f1 {f1_macro:.4f} "
              f"micro-f1 {f1_micro:.4f}")
    res = np.asarray([r["metrics"] for r in runs])
    mean, std = res.mean(0), res.std(0)
    print(f"{args.method} {inputs.task}"
          f"{'_direction_only' * args.direction_only} "
          f"mean acc {mean[0]:.4f} +/- {std[0]:.4f} "
          f"macro-f1 {mean[1]:.4f} micro-f1 {mean[2]:.4f}")
    return result(inputs, runs)


if __name__ == "__main__":
    main()
