"""What the DGCN and DiGCN node experiments share: the real directed
dataset, its edge-weight transform and features, and a split's training
on the masked NLL with one test forward.  Each experiment module supplies
``features(args, data, w)``, ``operator_arrays(args, data, w, n)`` (the
host arrays of its operators), ``propagator`` (the function that makes
them operators) and ``make_model(args, inputs, split)``; its model is
called as ``model(x, *operators)``."""
from types import SimpleNamespace

import numpy as np
import torch

from ..data import load_directed_real_data
from ..device import resolve_device
from ..graph import in_out_degree
from ..train import Trainer, masked_nll
from ._common import StageClock, accuracy, run_steps


def edge_weights(args, data) -> np.ndarray:
    """``--weights``: the raw weights, all ones, or log1p of them."""
    w = np.asarray(data.edge_weight, np.float32)
    if args.weights == "binary":
        return np.ones_like(w)
    if args.weights == "log":
        return np.log1p(w).astype(np.float32)
    return w


def flag_features(args, data, w) -> np.ndarray:
    """``--features x`` takes the dataset's own (where it has them),
    ``deg`` the in/out degrees by ``w`` over their largest."""
    if args.features == "x" and data.x is not None:
        return np.asarray(data.x, np.float32)
    xd = in_out_degree(data.edge_index, data.num_nodes, edge_weight=w)
    return np.asarray(xd, np.float32) / max(float(xd.max()), 1.0)


def build_inputs(args, device, exp) -> SimpleNamespace:
    """The dataset, its features and operators on ``device``, with the
    host seconds of each stage."""
    device = resolve_device(device)
    clock = StageClock(device)
    data = load_directed_real_data(args.dataset, name=args.dataset)
    clock.mark("load")
    n = data.num_nodes
    w = edge_weights(args, data) if hasattr(args, "weights") else \
        np.asarray(data.edge_weight, np.float32)
    x = exp.features(args, data, w)
    clock.mark("features")
    arrays = exp.operator_arrays(args, data, w, n)
    clock.mark("operators")
    ops = tuple(exp.propagator(ei, ew, n, device=device) for ei, ew in arrays)
    clock.mark("layout")
    return SimpleNamespace(
        data=data, x=torch.from_numpy(x).to(device), ops=ops, arrays=arrays,
        y=torch.from_numpy(np.asarray(data.y)).to(device),
        label_dim=int(np.asarray(data.y).max()) + 1,
        num_edges=data.edge_index.shape[1], device=device,
        seconds=clock.seconds)


def train_split(args, inputs, split: int, model) -> dict:
    """``args.epochs`` Adam steps (coupled L2 ``args.weight_decay``) on the
    masked NLL of split ``split``'s training nodes (dropout off, as in the
    JAX experiment), then the test accuracy from one forward."""
    x, y, ops = inputs.x, inputs.y, inputs.ops
    mask = torch.from_numpy(
        inputs.data.train_mask[:, split].astype(np.float32)).to(inputs.device)

    def loss_fn(m, mask):
        return masked_nll(m(x, *ops), y, mask)

    trainer = Trainer(loss_fn, lr=args.lr, weight_decay=args.weight_decay,
                      device=inputs.device)
    run = run_steps(trainer, trainer.init(model), (mask,), args.epochs)
    test_idx = np.nonzero(inputs.data.test_mask[:, split])[0]
    with torch.no_grad():
        pred = model(x, *ops).argmax(1).cpu().numpy()
    return dict(run, acc=accuracy(pred[test_idx],
                                  np.asarray(inputs.data.y)[test_idx]),
                evals=1)
