"""Link sign prediction with SGCN, SNEA, SiGAT or SDGNN on a real signed
dataset.

Counterpart of ``pytorch_geometric_signed_directed_tpu/experiments/
run_link_sign_prediction.py``: the same flags, defaults and printed
lines, plus ``--device``.  The signed graph, unweighted, in one sign link
split; the model trained on its own loss (AdamW); the frozen embedding's
edges probed by a logistic regression (``utils.
link_sign_prediction_logistic_function``): accuracy, binary, macro and
micro F1 and AUC.
"""
import argparse
import time
from types import SimpleNamespace

import numpy as np

from ..data import load_signed_real_data
from ..device import resolve_device
from ..utils import link_class_split, link_sign_prediction_logistic_function
from ._common import StageClock, add_device_arg, result
from ._signed_embedding import (EMBEDDING_METHODS, embedding_model,
                                train_embedding)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m pytorch_geometric_signed_directed_tpu_torch "
        "link_sign_prediction")
    ap.add_argument("--dataset", default="bitcoin_alpha")
    ap.add_argument("--model", default="sgcn", choices=EMBEDDING_METHODS)
    ap.add_argument("--emb_dim", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--weight_decay", type=float, default=1e-5)
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    return ap


def build_inputs(args, device) -> SimpleNamespace:
    """The dataset (unweighted), its sign link split, and the model with
    its inputs on ``device``, with the host seconds of each stage."""
    device = resolve_device(device)
    clock = StageClock(device)
    data = load_signed_real_data(args.dataset)
    data.to_unweighted()
    clock.mark("load")
    n = data.num_nodes
    datasets = link_class_split(data, splits=1, task="sign", seed=args.seed,
                                maintain_connect=False)
    clock.mark("link_split")
    tr, te = datasets[0]["train"], datasets[0]["test"]
    train_edges = np.asarray(tr["edges"])
    train_y = np.asarray(tr["label"])
    edge_index_s = np.concatenate(
        [train_edges, np.where(train_y == 1, 1, -1)[:, None]], axis=1)
    emb = embedding_model(args.model, n, edge_index_s, args.emb_dim,
                          args.emb_dim, args.seed, device)
    clock.mark("operators")
    return SimpleNamespace(
        data=data, emb=emb, train_edges=train_edges, train_y=train_y,
        test_edges=np.asarray(te["edges"]), test_y=np.asarray(te["label"]),
        num_edges=data.edge_index.shape[1], device=device,
        seconds=clock.seconds)


def train(args, inputs) -> dict:
    r = train_embedding(inputs.emb, args.epochs, args.lr, args.weight_decay,
                        inputs.device)
    t0 = time.perf_counter()
    metrics = link_sign_prediction_logistic_function(
        r["z"], inputs.train_edges, inputs.train_y, inputs.test_edges,
        inputs.test_y)
    return dict(r, acc=metrics[0], metrics=metrics, evals=1,
                host_seconds={"probe": time.perf_counter() - t0})


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    inputs = build_inputs(args, args.device)
    r = train(args, inputs)
    for epoch in range(49, len(r["losses"]), 50):
        print(f"epoch {epoch + 1}: loss {r['losses'][epoch]:.4f}")
    acc, f1, f1_macro, f1_micro, auc = r["metrics"]
    print(f"acc {acc:.4f}  f1 {f1:.4f}  macro {f1_macro:.4f}  "
          f"micro {f1_micro:.4f}  auc {auc:.4f}")
    return result(inputs, [r])


if __name__ == "__main__":
    main()
