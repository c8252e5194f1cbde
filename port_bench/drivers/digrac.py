"""The port's DIGRAC clustering at scale, as the window drives it.

Preparation: degree features, the fused walk dual
(``graph.rw_norm_dual_propagator``: [P_s x_s | P_t x_t] in one apply)
and the fused adjacency dual (``graph.adj_dual_propagator``: [A P |
A^T P]), as ``scripts/giant_digrac_torch.py --fused`` builds them.  The
epoch is one eager step, as that script's ``step()``: the training
forward (dropout drawn from the harness's dropout seed),
``utils.Prob_Imbalance_Loss``, backward, ``train.adam``; the loss stays
on the device.
"""
import torch

from port_bench import cost
from port_bench.drivers import common
from pytorch_geometric_signed_directed_tpu_torch.graph import (
    adj_dual_propagator, rw_norm_dual_propagator)
from pytorch_geometric_signed_directed_tpu_torch.nn import (
    DIGRAC_node_clustering)
from pytorch_geometric_signed_directed_tpu_torch.train import adam
from pytorch_geometric_signed_directed_tpu_torch.utils import (
    Prob_Imbalance_Loss)


class Program:
    def __init__(self, config: dict, graph: dict, inputs: dict, device):
        self.config, self.graph, self.inputs = config, graph, inputs
        self.device = torch.device(device)
        if config["operators"] != "fused":
            raise ValueError("the driver runs the fused duals only")

    counters = staticmethod(common.counters)

    def prepare(self) -> None:
        c, g = self.config, self.graph
        common.set_precision(c)
        self.x = common.features(g, self.device)
        ei, w, n = g["edge_index"], g["edge_weight"], g["num_nodes"]
        self.walk = rw_norm_dual_propagator(ei, w, n,
                                            fill_value=c["fill_value"],
                                            device=self.device)
        self.adj = adj_dual_propagator(ei, w, n, device=self.device)

    def build(self, params: dict, capacity: int) -> None:
        c = self.config
        model = DIGRAC_node_clustering(
            num_features=c["num_features"], hidden=c["hidden"],
            nclass=c["num_clusters"], fill_value=c["fill_value"],
            dropout=c["dropout"], hop=c["hop"], device=self.device)
        model.load_state_dict(params, strict=True)
        self.model = model
        self.params0 = {k: v.detach().clone()
                        for k, v in model.named_parameters()}
        self.opt = adam(c["lr"], c["weight_decay"])(model.parameters())
        self.gen = common.dropout_generator(self.inputs, self.device)
        self.loss = Prob_Imbalance_Loss(int(c["loss"]["sel"]))
        self.losses = torch.zeros(capacity, device=self.device)
        self.dispatched = 0
        self.launches = {}

    def dispatch(self) -> None:
        """Enqueue one eager step; its loss lands in ``losses`` on the
        device."""
        c = self.config
        self.opt.zero_grad(set_to_none=True)
        prob = self.model(self.walk, None, self.x, True, self.gen)[3]
        loss = self.loss(prob, self.adj, c["num_clusters"],
                         c["loss"]["normalization"], c["loss"]["threshold"])
        loss.backward()
        self.opt.step()
        self.losses[self.dispatched].copy_(loss.detach())
        self.dispatched += 1

    def first_steps(self) -> None:
        self.dispatch()
        self.grad1 = common.first_gradient(self.model, self.opt)
        self.dispatch()
        self.dispatch()
        self.change3 = {k: p.detach() - self.params0[k]
                        for k, p in self.model.named_parameters()}

    def readings(self) -> dict:
        return dict(losses=[float(v) for v in self.losses[:3].cpu()],
                    grad1=self.grad1, change=self.change3)

    def calls_per_epoch(self, counted: dict, epochs: int) -> float:
        return sum(counted.values()) / epochs

    def applies_per_epoch(self):
        """hop applies of the walk dual at 2 x hidden lanes forward and
        hop transposed ones backward; one of the adjacency dual at 2 x
        clusters lanes forward and one transposed backward."""
        c, n = self.config, self.graph["num_nodes"]
        walk = cost.Apply(n, n, self.walk.col.numel(), 2, 2 * c["hidden"])
        adj = cost.Apply(n, n, self.adj.col.numel(), 2,
                         2 * c["num_clusters"])
        return [walk] * (2 * c["hop"]) + [adj] * 2

    def flops_per_epoch(self) -> float:
        """Dense transforms from the configuration's shapes: the two MLPs
        (first layer: forward and weight gradient; second: forward,
        weight and input gradients), the head and the [K, K] flows
        P^T (A P) (forward and both gradients), plus 2 nnz W a sparse
        apply."""
        c = self.config
        n, f, h, k = (self.graph["num_nodes"], c["num_features"],
                      c["hidden"], c["num_clusters"])
        mm = cost.matmul_flops
        mlp = 2 * (2 * mm(n, f, h) + 3 * mm(n, h, h))
        flops = mlp + 3 * mm(n, 2 * h, k) + 3 * mm(k, n, k)
        return flops + sum(cost.apply_flops(a)
                           for a in self.applies_per_epoch())

    def release(self) -> None:
        for name in ("model", "opt", "gen", "walk", "adj", "x", "losses",
                     "grad1", "change3", "params0"):
            self.__dict__.pop(name, None)
