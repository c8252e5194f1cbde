"""DIGRAC self-supervised directed clustering.

Counterpart of ``pytorch_geometric_signed_directed_tpu/experiments/
digrac.py``: the same flags, defaults and printed line, plus ``--device``.
A DSBM graph (``--dataset dsbm``) or a real directed dataset, Hermitian
or degree features, the DIMPA trunk trained on the probabilistic
imbalance loss, and the adjusted Rand index of the clusters against the
planted ones; a real dataset has none, so its meta-graph is the complete
one (every ordered pair of clusters a candidate flow) and its line gives
the loss, the score 1 - loss and the clusters used.  ``build_inputs`` makes
the graph, features and operators; ``train`` trains; ``main`` runs both.
"""
import argparse
from types import SimpleNamespace

import numpy as np
import torch

from ..data import DSBM, DirectedData, load_directed_real_data
from ..device import resolve_device
from ..graph import (adj_dual_propagator, in_out_degree, norm_propagator,
                     rw_norm_dual_propagator, rw_norm_propagator)
from ..nn import DIGRAC_node_clustering
from ..train import Trainer
from ..utils import (Prob_Imbalance_Loss, adjusted_rand_score,
                     meta_graph_generation)
from ._common import StageClock, add_device_arg, result, run_steps


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m pytorch_geometric_signed_directed_tpu_torch digrac")
    ap.add_argument("--dataset", default="dsbm")
    ap.add_argument("--N", type=int, default=500)
    ap.add_argument("--K", type=int, default=3)
    ap.add_argument("--p", type=float, default=0.1)
    ap.add_argument("--eta", type=float, default=0.05)
    ap.add_argument("--F_style", default="cyclic")
    ap.add_argument("--hop", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--features", default="hermitian",
                    choices=["hermitian", "degree"])
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--normalization", default="vol_sum")
    ap.add_argument("--threshold", default="sort")
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    return ap


def operators(edge_index, edge_weight, n: int, device, fused: bool = False):
    """DIGRAC's operators: (P_s, P_t, A) with the two walk Propagators and
    the (P_A, P_AT) pair of the imbalance volumes, or, ``fused``, the
    walk DualPropagator with P_t None and the A/A^T DualPropagator."""
    if fused:
        return (rw_norm_dual_propagator(edge_index, edge_weight, n,
                                        device=device), None,
                adj_dual_propagator(edge_index, edge_weight, n,
                                    device=device))
    rev = edge_index[[1, 0]]
    return (rw_norm_propagator(edge_index, edge_weight, n, device=device),
            rw_norm_propagator(rev, edge_weight, n, device=device),
            (norm_propagator(rev, edge_weight, n, device=device),
             norm_propagator(edge_index, edge_weight, n, device=device)))


def build_inputs(args, device) -> SimpleNamespace:
    """The DSBM graph, its features and operators, with the host seconds
    of each stage."""
    device = resolve_device(device)
    clock = StageClock(device)
    if args.dataset == "dsbm":
        F = meta_graph_generation(args.F_style, args.K, args.eta, False)
        A, labels = DSBM(args.N, args.K, args.p, F,
                         rng=np.random.default_rng(args.seed))
        data = DirectedData(A=A, y=labels)
    else:
        data = load_directed_real_data(args.dataset)
        labels = None
        F = meta_graph_generation("complete", args.K, 0.0, False)
    n = data.num_nodes
    clock.mark("graph")
    if args.features == "hermitian":
        data.set_hermitian_features(k=args.K)
        x = np.asarray(data.x, np.float32)
    else:
        x = in_out_degree(data.edge_index, n, edge_weight=data.edge_weight)
        x = x / max(x.max(), 1.0)
    x = torch.from_numpy(x).to(device)
    clock.mark("features")
    P_s, P_t, A_pair = operators(data.edge_index, data.edge_weight, n, device)
    clock.mark("operators")
    return SimpleNamespace(data=data, labels=labels, F=F, x=x, P_s=P_s,
                           P_t=P_t, A=A_pair, num_edges=data.edge_index.shape[1],
                           device=device, seconds=clock.seconds)


def make_model(args, inputs) -> DIGRAC_node_clustering:
    return DIGRAC_node_clustering(
        num_features=int(inputs.x.shape[1]), hidden=args.hidden,
        nclass=args.K, fill_value=0.5, dropout=args.dropout, hop=args.hop,
        device=inputs.device,
        generator=torch.Generator().manual_seed(args.seed))


def loss_function(args, inputs, imb):
    """``loss(model)``: the imbalance loss of the model's cluster
    probabilities (dropout off, as in the JAX experiment)."""
    x, P_s, P_t, A = inputs.x, inputs.P_s, inputs.P_t, inputs.A

    def loss_fn(m):
        prob = m(P_s, P_t, x)[3]
        return imb(prob, A, args.K, args.normalization, args.threshold)

    return loss_fn


def train(args, inputs, model=None) -> dict:
    """``args.epochs`` Adam steps, then one forward: the clusters, their
    ARI against the planted labels (None without labels), the final loss
    and the cluster sizes.  ``acc`` is the ARI, or the score 1 - loss
    where there are no labels."""
    model = make_model(args, inputs) if model is None else model
    imb = Prob_Imbalance_Loss(inputs.F)
    trainer = Trainer(loss_function(args, inputs, imb), lr=args.lr,
                      device=inputs.device)
    run = run_steps(trainer, trainer.init(model), (), args.epochs)
    with torch.no_grad():
        _, _, pred, prob = model(inputs.P_s, inputs.P_t, inputs.x)
        final = float(imb(prob, inputs.A, args.K, args.normalization,
                          args.threshold))
    pred = pred.cpu().numpy()
    ari = (None if inputs.labels is None
           else adjusted_rand_score(inputs.labels, pred))
    return dict(run, acc=1.0 - final if ari is None else ari, ari=ari,
                loss=final, pred=pred, sizes=np.bincount(pred,
                                                         minlength=args.K),
                evals=1)


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    inputs = build_inputs(args, args.device)
    r = train(args, inputs)
    if r["ari"] is not None:
        print(f"ARI {r['ari']:.4f}  imbalance loss {r['loss']:.4f} "
              f"({r['seconds']:.1f}s)")
    else:
        print(f"{args.dataset}: imbalance loss {r['loss']:.4f}  "
              f"score {1.0 - r['loss']:.4f}  "
              f"({args.normalization}/{args.threshold}, K={args.K}, "
              f"clusters used {int((r['sizes'] > 0).sum())}/{args.K}, "
              f"{r['seconds']:.1f}s)")
    return result(inputs, [r])


if __name__ == "__main__":
    main()
