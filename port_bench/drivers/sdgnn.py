"""The port's SDGNN at scale, as the window drives it.

Preparation: ``prepare_sdgnn_inputs`` on the signed edge list (the sign
split, the spectral input embedding, the four motif graphs and the
triangle weights), with the edge lists and weights then held on the
card as ``plan_edges``' ``PlannedEdges``, as ``run_link_sign_prediction``
holds them (the losses' gathers then take their backward on K1).  The epoch is one eager full-batch step over
every signed edge: ``SDGNN.loss`` (sign, direction and triangle losses),
backward and the port's AdamW (``train.adam(lr, wd, decoupled=True)``);
the loss stays on the device.  The attention aggregates are K1
``csr_scatter_sum``: on the motif stack (``fused``) one a layer forward
and two backward (by source and by destination); one GATConv a motif
graph otherwise, one a GAT forward (the backward a gather).  The
harness's parameters and the readings are in the per-motif names of the
reference either way.

A port without ``plan_edges`` cannot run this configuration: the
program refuses it before the set-up, and the run exits with no result.
"""
import numpy as np
import torch

from port_bench import cost, cost_scatter
from port_bench.drivers import common
from port_bench.reference import sdgnn as reference
from pytorch_geometric_signed_directed_tpu_torch.nn import SDGNN
from pytorch_geometric_signed_directed_tpu_torch.nn.signed import snea_conv
from pytorch_geometric_signed_directed_tpu_torch.nn.signed.motif_stack import (
    stack_state_dict)
from pytorch_geometric_signed_directed_tpu_torch.nn.signed.sdgnn import (
    prepare_sdgnn_inputs)
from pytorch_geometric_signed_directed_tpu_torch.train import adam
from pytorch_geometric_signed_directed_tpu_torch.utils.signed import (
    link_sign_loss)

# the losses' gathers of z: at the sources and the destinations of each
# edge list, in the sign, direction and triangle losses
LOSS_GATHERS = 3


def counters() -> dict:
    """The kernel wrapper calls and the attention aggregates
    (``attends``)."""
    return dict(common.counters(), attends=sum(snea_conv.ATTENDS.values()))


def per_motif(leaves: dict) -> dict:
    """A fused SDGNN's leaves under the per-motif names (the inverse of
    ``stack_state_dict``): ``<prefix>agg_stack.kernel`` [G, in, out]
    becomes each ``<prefix>aggs.<m>.linear.weight`` [out, in], and
    ``att_src``, ``att_dst``, ``bias`` split by motif."""
    out = {}
    for k, v in leaves.items():
        head, sep, name = k.partition("agg_stack.")
        if not sep:
            out[k] = v
            continue
        for m in range(v.shape[0]):
            if name == "kernel":
                out[f"{head}aggs.{m}.linear.weight"] = v[m].T
            else:
                out[f"{head}aggs.{m}.{name}"] = v[m]
    return out


class Program:
    def __init__(self, config: dict, graph: dict, inputs: dict, device):
        self.config, self.graph, self.inputs = config, graph, inputs
        self.device = torch.device(device)
        if not config["fused"] and config["aggregate"] != "mxu":
            raise ValueError("the driver runs the GATs on K1")
        if not config["decoupled_weight_decay"]:
            raise ValueError("the configuration trains with AdamW")
        if not hasattr(link_sign_loss, "plan_edges"):
            raise RuntimeError(
                "the configuration holds its edge lists as planned edges "
                "(utils.signed.link_sign_loss.plan_edges), which this port "
                "lacks")

    counters = staticmethod(counters)

    def prepare(self) -> None:
        c, g = self.config, self.graph
        common.set_precision(c)
        es = np.vstack([g["edge_index"], g["edge_sign"]]).T
        pos, neg, self.emb, self.graphs, w_pos, w_neg = prepare_sdgnn_inputs(
            g["num_nodes"], es, c["in_dim"], fused=c["fused"],
            device=self.device)

        self.pos, self.neg = (
            link_sign_loss.plan_edges(e, g["num_nodes"], self.device)
            for e in (pos, neg))
        self.w_pos, self.w_neg = (
            torch.as_tensor(w, dtype=torch.float32, device=self.device)
            for w in (w_pos, w_neg))

    def build(self, params: dict, capacity: int) -> None:
        c, n = self.config, self.graph["num_nodes"]
        model = SDGNN(node_num=n, in_dim=c["in_dim"], out_dim=c["out_dim"],
                      layer_num=c["layer_num"], lamb_d=c["lamb_d"],
                      lamb_t=c["lamb_t"], init_emb_grad=c["init_emb_grad"],
                      init_emb=self.emb, fused=c["fused"],
                      aggregate=c["aggregate"], device=self.device)
        for layer in model.layers:
            for agg in ([layer.agg_stack] if c["fused"] else layer.aggs):
                agg.negative_slope = c["negative_slope"]
        state = dict(params, x=reference.input_embedding(
            n, c["in_dim"], self.inputs, self.device))
        if c["fused"]:
            state = stack_state_dict(state)
        model.load_state_dict(state, strict=True)
        self.model = model
        self.params0 = {k: v.detach().clone()
                        for k, v in model.named_parameters()}
        self.opt = adam(c["lr"], c["weight_decay"], decoupled=True)(
            model.parameters())
        self.losses = torch.zeros(capacity, device=self.device)
        self.dispatched = 0

    def dispatch(self) -> None:
        """Enqueue one eager step; its loss lands in ``losses`` on the
        device."""
        self.opt.zero_grad(set_to_none=True)
        loss = self.model.loss(self.graphs, self.pos, self.neg, self.w_pos,
                               self.w_neg)
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
                    grad1=per_motif(self.grad1),
                    change=per_motif(self.change3))

    def calls_per_epoch(self, counted: dict, epochs: int) -> float:
        """K1 ``csr_scatter_sum`` calls an epoch."""
        return counted.get("csr_scatter_sum", 0) / epochs

    def applies_per_epoch(self):
        """The segment sums of an epoch: on the motif stack, a layer's
        forward over its G N rows and all the motif graphs' edges
        (self-loops included) at 1 + out lanes ([exp | msgs exp]), and
        its backward's sums by source (G N + 1 rows, out + 1 lanes) and
        by destination (G N rows, 1 lane); per motif, one a GAT forward
        (N rows, the graph's edges, 1 + out lanes); then the backward of
        each of the losses' gathers of z (N rows, the edge list's edges,
        out lanes)."""
        c, n = self.config, self.graph["num_nodes"]
        f, layers = c["out_dim"], c["layer_num"]
        if c["fused"]:
            g = self.graphs.g
            gn, nnz = g.num_nodes, int(g.src.numel())
            out = [cost_scatter.Scatter(*shape) for _ in range(layers)
                   for shape in ((gn, nnz, 1 + f), (gn + 1, nnz, f + 1),
                                 (gn, nnz, 1))]
        else:
            out = [cost_scatter.Scatter(n, int(g.src.numel()), 1 + f)
                   for _ in range(layers) for g in self.graphs]
        return out + [cost_scatter.Scatter(n, e.shape[1], f)
                      for e in (self.pos, self.neg)
                      for _ in range(2 * LOSS_GATHERS)]

    def flops_per_epoch(self) -> float:
        """From the configuration's shapes, forward and backward (3 GEMMs
        a dense transform: every input needs a gradient): each
        GAT's h = x W and its two attention products, each layer's two
        Linears, the losses' products on the edges (the sign loss's dot
        products, the two score Linears, the triangle Linear), plus
        nnz W a segment sum of ``applies_per_epoch`` (a gather backward
        that is not one of them adds nothing)."""
        c, n = self.config, self.graph["num_nodes"]
        f, G = c["out_dim"], len(reference.DIRECTIONS)
        mm = cost.matmul_flops
        flops = 0
        for i in range(c["layer_num"]):
            d_in = c["in_dim"] if i == 0 else f
            flops += G * 3 * (mm(n, d_in, f) + 2 * mm(n, f, 1))
            flops += 3 * (mm(n, d_in + G * f, f) + mm(n, f, f))
        e = self.pos.shape[1] + self.neg.shape[1]
        flops += 3 * (2 * e * f + 2 * mm(e, f, 1) + mm(e, 2 * f, 1))
        return flops + sum(cost_scatter.scatter_flops(s)
                           for s in self.applies_per_epoch())

    def release(self) -> None:
        for name in ("model", "opt", "graphs", "emb", "pos", "neg", "w_pos",
                     "w_neg", "losses", "grad1", "change3", "params0"):
            self.__dict__.pop(name, None)
