"""The port's MagNet node classification, as the window drives it.

Preparation: degree features and ``spectral.magnet_propagators`` (the
magnetic Laplacian pair and its layout on the card, in the tier
``mode`` picks).  The epoch is ``train.SplitRun``'s: the training step
(dropout drawn from the harness's dropout seed) on the masked NLL with
``train.adam`` (coupled L2), then the evaluation forward and the
best-validation selection, all on the device.  On the
card the first epoch runs eagerly and the second is captured as a CUDA
graph; every later epoch is a replay.
"""
import numpy as np
import torch

from port_bench import cost
from port_bench.drivers import common
from pytorch_geometric_signed_directed_tpu_torch.nn import (
    MagNet_node_classification)
from pytorch_geometric_signed_directed_tpu_torch.spectral import (
    magnet_propagators)
from pytorch_geometric_signed_directed_tpu_torch.train import SplitRun, adam


class Program:
    def __init__(self, config: dict, graph: dict, inputs: dict, device):
        self.config, self.graph, self.inputs = config, graph, inputs
        self.device = torch.device(device)

    counters = staticmethod(common.counters)

    def prepare(self) -> None:
        c, g = self.config, self.graph
        common.set_precision(c)
        self.x = common.features(g, self.device)
        self.lap = magnet_propagators(
            g["edge_index"], g["edge_weight"], q=c["q"],
            num_nodes=g["num_nodes"], mode=c["mode"], device=self.device)

    def build(self, params: dict, capacity: int) -> None:
        """The model from ``params``, its optimizer and a SplitRun of
        ``capacity`` epochs (the most this process may dispatch)."""
        c, dev = self.config, self.device
        model = MagNet_node_classification(
            num_features=c["num_features"], hidden=c["hidden"], q=c["q"],
            K=c["K"], label_dim=c["num_classes"], activation=True,
            layer=c["layers"], dropout=c["dropout"], device=dev)
        model.load_state_dict(params, strict=True)
        x, lap = self.x, self.lap

        def apply_fn(m, training, generator):
            return m(x, x, lap, training, generator)

        y = torch.as_tensor(np.asarray(self.inputs["labels"]),
                            dtype=torch.long, device=dev)
        masks = torch.as_tensor(self.inputs["masks"], dtype=torch.float32,
                                device=dev)
        self.model = model
        self.params0 = {k: v.detach().clone()
                        for k, v in model.named_parameters()}
        self.run = SplitRun(apply_fn, model,
                            adam(c["lr"], c["weight_decay"]), y, masks[0],
                            masks[1], masks[2], capacity,
                            generator=common.dropout_generator(
                                self.inputs, dev))
        self.dispatched = 0

    def dispatch(self) -> None:
        """Enqueue one epoch: a graph replay once captured."""
        if self.run.graph is not None:
            self.run.graph.replay()
        else:
            self.run.epoch()
        self.dispatched += 1

    def first_steps(self) -> None:
        """Epoch 1 (eagerly; on the card the capture follows it), then
        epochs 2 and 3 through ``dispatch``; keeps the first gradient and
        the change of the parameters after the three."""
        if self.device.type == "cuda":
            self.run.capture()
        else:
            self.run.epoch()
        self.dispatched = 1
        self.grad1 = common.first_gradient(self.model, self.run.opt)
        self.dispatch()
        self.dispatch()
        self.change3 = {k: p.detach() - self.params0[k]
                        for k, p in self.model.named_parameters()}

    def readings(self) -> dict:
        return dict(losses=[float(v) for v in self.run.losses[:3].cpu()],
                    grad1=self.grad1, change=self.change3)

    def calls_per_epoch(self, counted: dict, epochs: int) -> float:
        """Kernel wrapper calls an epoch: those of the capture (a replay
        counts none), or those counted over ``epochs`` eager epochs."""
        if self.run.graph is not None:
            return float(sum(self.run.launches_per_replay.values()))
        return sum(counted.values()) / epochs

    def applies_per_epoch(self):
        """The sparse applies of an epoch: on each layer K forward
        applies at the layer's lane-stacked width, K transposed ones in
        the backward of every layer after the first (the features carry
        no gradient), and the K forward ones again in the evaluation."""
        c, D = self.config, self.lap.dual
        if D is None:
            return []
        n, nnz = D.num_nodes, D.col.numel()
        widths = [2 * (c["num_features"] if i == 0 else c["hidden"])
                  for i in range(c["layers"])]
        out = []
        for i, w in enumerate(widths):
            count = c["K"] * (2 if i == 0 else 3)
            out += [cost.Apply(n, n, nnz, 2, w)] * count
        return out

    def flops_per_epoch(self) -> float:
        """Dense transforms from the configuration's shapes (each conv's
        two [K+1] stacks by its weight, the head; forward, the backward
        products that have an operand needing a gradient, the evaluation
        forward) plus 2 nnz W a sparse apply."""
        c = self.config
        n, K, h, C = self.graph["num_nodes"], c["K"], c["hidden"], \
            c["num_classes"]
        mm = cost.matmul_flops
        flops = 0.0
        for i in range(c["layers"]):
            fin = c["num_features"] if i == 0 else h
            conv = 2 * mm(n, (K + 1) * fin, h)
            # forward, weight gradient, input gradient (not the first
            # layer's), evaluation forward
            flops += conv * (3 + (i > 0))
        flops += mm(n, 2 * h, C) * 4
        return flops + sum(cost.apply_flops(a)
                           for a in self.applies_per_epoch())

    def release(self) -> None:
        for name in ("run", "model", "lap", "x", "grad1", "change3",
                     "params0"):
            self.__dict__.pop(name, None)
