"""SSSNET semi-supervised signed clustering on a signed SBM.

Counterpart of ``pytorch_geometric_signed_directed_tpu/experiments/
sssnet.py``: the same flags, defaults and printed lines, plus
``--device``.  An SSBM graph (``--dataset ssbm``, size ratio 1.5) cut to
its largest component, or a labelled real signed dataset (K from its
labels), the regularized-adjacency eigenvector features,
two node splits, the SIMPA trunk trained on 50 (NLL + 0.1 triplet) + the
balanced normalized cut, and the test ARI and unhappy ratio of each split.
``build_inputs`` makes the graph, features, operators and losses;
``train_split`` trains one split; ``main`` runs both.

The features come from ARPACK's ``eigs`` with a random start vector, so
they, and the run, differ from call to call (in both packages).
"""
import argparse
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..data import SSBM, SignedData, load_signed_real_data
from ..device import resolve_device
from ..graph import rw_norm_propagator
from ..nn import SSSNET_node_clustering
from ..train import Trainer
from ..utils import (Prob_Balanced_Normalized_Loss, Unhappy_Ratio,
                     adjusted_rand_score, extract_network)
from ..utils.general.triplet_loss import (sample_triplets,
                                          triplet_loss_inner_product)
from ._common import StageClock, add_device_arg, result, run_steps

# triplets sampled a step, as the JAX experiment
N_TRIPLETS = 200


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m pytorch_geometric_signed_directed_tpu_torch sssnet")
    ap.add_argument("--dataset", default="ssbm")
    ap.add_argument("--N", type=int, default=500)
    ap.add_argument("--K", type=int, default=3)
    ap.add_argument("--p", type=float, default=0.1)
    ap.add_argument("--eta", type=float, default=0.1)
    ap.add_argument("--hop", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seed_ratio", type=float, default=0.1)
    add_device_arg(ap)
    return ap


def build_inputs(args, device) -> SimpleNamespace:
    """The SSBM graph, its features and node splits, the two walk
    Propagators and the losses' operators on ``device``, with the host
    seconds of each stage."""
    device = resolve_device(device)
    clock = StageClock(device)
    if args.dataset == "ssbm":
        (A_p, A_n), labels = SSBM(args.N, args.K, args.p, args.eta,
                                  size_ratio=1.5,
                                  rng=np.random.default_rng(args.seed))
        A, labels = extract_network((A_p - A_n).tocsr(), labels)
        data = SignedData(A=A, y=labels)
    else:
        data = load_signed_real_data(args.dataset)
        if data.y is None:
            raise SystemExit(f"{args.dataset} carries no labels; the "
                             "clustering ARI protocol needs them")
        args.K = int(np.asarray(data.y).max()) + 1
    clock.mark("graph")
    data.set_spectral_adjacency_reg_features(k=args.K)
    clock.mark("features")
    data.node_split(train_size_per_class=0.8, val_size_per_class=0.1,
                    seed_size_per_class=args.seed_ratio, data_split=2)
    data.separate_positive_negative()
    n = data.num_nodes
    clock.mark("split")
    x = torch.from_numpy(np.asarray(data.x, np.float32)).to(device)
    P_p = rw_norm_propagator(data.edge_index_p, data.edge_weight_p, n, 0.5,
                             device=device)
    P_n = rw_norm_propagator(data.edge_index_n, data.edge_weight_n, n, 0.0,
                             device=device)
    A_p, A_n = data.A_p.tocsr(), data.A_n.tocsr()
    cut = Prob_Balanced_Normalized_Loss(A_p, A_n, device=device)
    unhappy = Unhappy_Ratio(A_p, A_n, device=device)
    clock.mark("operators")
    return SimpleNamespace(data=data, x=x, P_p=P_p, P_n=P_n, cut=cut,
                           unhappy=unhappy,
                           y=torch.from_numpy(np.asarray(data.y)).to(device),
                           num_edges=data.edge_index.shape[1], device=device,
                           seconds=clock.seconds)


def make_model(args, inputs) -> SSSNET_node_clustering:
    return SSSNET_node_clustering(
        nfeat=int(inputs.x.shape[1]), hidden=args.hidden, nclass=args.K,
        hop=args.hop, device=inputs.device,
        generator=torch.Generator().manual_seed(args.seed))


def triplet_batches(args, inputs, epochs: int):
    """Each step's (i1, i2, idif) on the card, stacked [epochs, 3, M]: the
    draws of the JAX experiment's per-step sampler, in its order (one
    generator seeded by ``--seed`` for each split), made before training
    so that no step waits on a host copy.  Returns (tensor,
    n_sample_class, nclass)."""
    rng = np.random.default_rng(args.seed)
    y, n = np.asarray(inputs.data.y), inputs.data.num_nodes
    draws = [sample_triplets(y, n, N_TRIPLETS, rng) for _ in range(epochs)]
    stacked = np.stack([np.stack(d[:3]) for d in draws])
    return (torch.from_numpy(stacked).to(inputs.device), draws[0][3],
            draws[0][4])


def loss_function(inputs, split: int, n_sample_class: int, nclass: int):
    """``loss(model, triplets)``: 50 (NLL on the split's training nodes +
    0.1 triplet loss) + the balanced normalized cut (dropout off, as in the
    JAX experiment)."""
    mask = inputs.data.train_mask[:, split]
    train_idx = torch.from_numpy(np.nonzero(mask)[0]).to(inputs.device)
    y_train = inputs.y[train_idx]

    def loss_fn(m, triplets):
        z, logp, _, prob = m(inputs.P_p, inputs.P_n, inputs.x)
        nll = -logp[train_idx, y_train].mean()
        tl = triplet_loss_inner_product(z, *triplets, n_sample_class, nclass)
        return 50.0 * (nll + 0.1 * tl) + inputs.cut(prob)

    return loss_fn


def train_split(args, inputs, split: int, model=None) -> dict:
    """``args.epochs`` Adam steps on one split, then one forward: the test
    ARI, the unhappy ratio, the clusters and the host seconds of the
    sampler."""
    model = make_model(args, inputs) if model is None else model
    t0 = time.perf_counter()
    triplets, n_sample_class, nclass = triplet_batches(args, inputs,
                                                       args.epochs)
    sampled = time.perf_counter() - t0
    trainer = Trainer(loss_function(inputs, split, n_sample_class, nclass),
                      lr=args.lr, device=inputs.device)
    run = run_steps(trainer, trainer.init(model), lambda e: (triplets[e],),
                    args.epochs)
    with torch.no_grad():
        _, _, pred, prob = model(inputs.P_p, inputs.P_n, inputs.x)
        unhappy = float(inputs.unhappy(prob))
    pred = pred.cpu().numpy()
    test = np.nonzero(inputs.data.test_mask[:, split])[0]
    ari = adjusted_rand_score(np.asarray(inputs.data.y)[test], pred[test])
    return dict(run, acc=ari, ari=ari, unhappy=unhappy, pred=pred, evals=1,
                host_seconds={"samplers": sampled})


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    inputs = build_inputs(args, args.device)
    runs = []
    for split in range(inputs.data.train_mask.shape[1]):
        r = train_split(args, inputs, split)
        runs.append(r)
        print(f"split {split}: test ARI {r['ari']:.4f} unhappy "
              f"{r['unhappy']:.4f}")
    aris = [r["ari"] for r in runs]
    print(f"mean ARI: {np.mean(aris):.4f} +/- {np.std(aris):.4f}")
    return result(inputs, runs)


if __name__ == "__main__":
    main()
