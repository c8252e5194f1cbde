"""Plain SDGNN (Huang, Shen, Hou and Cheng, AAAI 2021), in float64.

The node embedding x [N, F] (a parameter) passes ``layer_num`` layers.
A layer runs four single-head GATs, one a signed direction: positive
out, positive in, negative out, negative in.  The GAT of direction m
holds the pairs (s, d) of that direction (positive out: each positive
u -> v as (u, v); positive in: as (v, u); the negative ones alike),
each distinct pair once, self-pairs dropped and a self-loop at every
node added (as PyG's GATConv adds them).  Node d then gathers from every
s of its pairs: h = x W^T, logit_sd = leaky_relu(h_s . a_src + h_d .
a_dst, 0.2) (slope 1 at 0), alpha_sd = exp(logit_sd - max_d) / sum over
d's pairs (max_d the largest logit at d: a softmax by destination,
exact at any spread of the logits), out_d = sum_s alpha_sd h_s + b.  The
layer concatenates [x | the four outputs] and applies Linear, tanh,
Linear.

The loss over the signed edges, with z the last layer's output:

* sign: sum over positive u -> v of softplus(-z_u . z_v), over negative
  ones of softplus(z_u . z_v);
* direction (times ``lamb_d``): with d = sigmoid(z_u w1 + b1) -
  sigmoid(z_v w2 + b2), positive edges add max(d + 0.5, 0)^2 and
  negative ones max(0.5 - d, 0)^2;
* triangle (times ``lamb_t``): a score t = [z_u | z_v] w + b, positive
  edges add c_uv softplus(-t) and negative ones c_uv softplus(t), c_uv
  the edge's triangle count (``triangle_weights``).

AdamW (decoupled decay, as torch.optim.AdamW) by hand.  The embedding is
drawn from the seed (``input_embedding``), the other parameters by the
harness (``param_spec``).
"""
import math

import numpy as np
import scipy.sparse as sp
import torch

from port_bench.reference import common

SLOPE = 0.2
DIRECTIONS = ("pos_out", "pos_in", "neg_out", "neg_in")


def param_spec(config: dict):
    """Every parameter of the port's ``SDGNN`` but its embedding ``x``,
    under the port's names: glorot weights, biases uniform(+-0.1)."""
    f_in, f, G = config["in_dim"], config["out_dim"], len(DIRECTIONS)
    spec = []
    for i in range(config["layer_num"]):
        d_in = f_in if i == 0 else f
        for m in range(G):
            p = f"layers.{i}.aggs.{m}."
            spec += [(p + "linear.weight", (f, d_in), "glorot", 1.0),
                     (p + "att_src", (f, 1), "glorot", 1.0),
                     (p + "att_dst", (f, 1), "glorot", 1.0),
                     (p + "bias", (f,), "uniform", 0.1)]
        p = f"layers.{i}."
        spec += [(p + "linear.weight", (f, d_in + G * f), "glorot", 1.0),
                 (p + "linear.bias", (f,), "uniform", 0.1),
                 (p + "linear1.weight", (f, f), "glorot", 1.0),
                 (p + "linear1.bias", (f,), "uniform", 0.1)]
    for k in (1, 2):
        p = f"loss_direction.score_function{k}."
        spec += [(p + "weight", (1, f), "glorot", 1.0),
                 (p + "bias", (1,), "uniform", 0.1)]
    spec += [("loss_tri.linear.weight", (1, 2 * f), "glorot", 1.0),
             ("loss_tri.linear.bias", (1,), "uniform", 0.1)]
    return spec


def input_embedding(num_nodes: int, dim: int, inputs: dict, device):
    """x [N, dim] float32, uniform(+-sqrt(3 / N)): columns of unit norm
    in expectation, the scale of the spectral embedding (unit singular
    vectors) the model starts from.  Drawn on ``device`` from the
    harness's second stream of the seed (``inputs["dropout_seed"]``;
    SDGNN draws no dropout mask), for the program and the reference
    alike."""
    return common.draw_params(
        [("x", (num_nodes, dim), "uniform", math.sqrt(3.0 / num_nodes))],
        int(inputs["dropout_seed"]), device)["x"]


def signed_pairs(graph: dict):
    """(positive [2, P], negative [2, Q]) host arrays of the graph."""
    ei, sign = np.asarray(graph["edge_index"]), np.asarray(graph["edge_sign"])
    return ei[:, sign > 0], ei[:, sign < 0]


def _adjacency(pairs, n) -> sp.csr_matrix:
    """The boolean adjacency (as 0/1 float64) of [2, E] pairs."""
    A = sp.csr_matrix((np.ones(pairs.shape[1]), (pairs[0], pairs[1])),
                      shape=(n, n))
    A.data[:] = 1.0
    return A


# The triad types each sign's weight counts: a triad u - w - v with the
# edge u -> v is named by its two legs, (u's leg to w, w's leg to v), each
# "P" / "N" for a positive / negative pair in the edge's direction (u ->
# w, w -> v) or "Pt" / "Nt" against it (w -> u, v -> w).  Its count over
# w is the product of the legs' adjacencies at (u, v).
TRIADS = {
    +1: [("P", "P"), ("P", "Pt"), ("N", "Nt"), ("Nt", "Nt"), ("Pt", "P"),
         ("Nt", "N")],
    -1: [("P", "N"), ("N", "P"), ("N", "Pt"), ("Pt", "Nt"), ("Nt", "Pt"),
         ("Pt", "N")],
}


def triangle_weights(pos, neg, n):
    """(c_pos [P], c_neg [Q]) float64: each signed edge's count of the
    triads of its sign's types (``TRIADS``), by scipy's products of the
    legs' adjacencies masked to the sign's edges.

    The library keeps one weight a directed pair: a pair that carries
    both signs gets the negative count on both of its edges.  The
    benchmark's traffic draws one sign a pair, so this never applies;
    the reference refuses such a graph rather than copy the rule."""
    P, N = _adjacency(pos, n), _adjacency(neg, n)
    if P.multiply(N).nnz:
        raise ValueError("a pair carries both signs")
    legs = {"P": P, "N": N, "Pt": P.T.tocsr(), "Nt": N.T.tocsr()}
    out = []
    for sign, pairs, mask in ((+1, pos, P), (-1, neg, N)):
        C = sp.csr_matrix((n, n))
        for a, b in TRIADS[sign]:
            C = C + (legs[a] @ legs[b]).multiply(mask)
        C = sp.csr_matrix(C)
        out.append(np.asarray(C[pairs[0], pairs[1]]).ravel())
    return tuple(out)


def _gat_pairs(pos, neg, n):
    """The four directions' (src, dst) int64 arrays, distinct, self-pairs
    dropped, a self-loop a node added."""
    loops = np.arange(n)
    out = []
    for pairs in (pos, pos[::-1], neg, neg[::-1]):
        key = np.unique(pairs[0].astype(np.int64) * n + pairs[1])
        s, d = key // n, key % n
        keep = s != d
        out.append((np.concatenate([s[keep], loops]),
                    np.concatenate([d[keep], loops])))
    return out


def prepare(config: dict, graph: dict, device, dtype=torch.float64):
    """The four directions' pairs, the signed edges and their triangle
    counts, on ``device``."""
    n = graph["num_nodes"]
    pos, neg = signed_pairs(graph)
    c_pos, c_neg = triangle_weights(pos, neg, n)

    def dev(a, t=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=t,
                               device=device)

    return dict(n=n, dtype=dtype,
                gat=[(dev(s), dev(d)) for s, d in _gat_pairs(pos, neg, n)],
                pos=dev(pos), neg=dev(neg), c_pos=dev(c_pos, dtype),
                c_neg=dev(c_neg, dtype))


def _gat(p, prefix, x, src, dst, n, fault=None):
    h = x @ p[prefix + "linear.weight"].T
    logit = (h @ p[prefix + "att_src"])[:, 0][src] + \
        (h @ p[prefix + "att_dst"])[:, 0][dst]
    logit = torch.where(logit >= 0, logit, SLOPE * logit)
    peak = torch.full((n,), -math.inf, dtype=x.dtype, device=x.device)
    peak = peak.scatter_reduce(0, dst, logit, reduce="amax",
                               include_self=True)
    ex = torch.exp(logit - peak[dst])
    denom = torch.zeros(n, dtype=x.dtype, device=x.device).index_add(
        0, dst, ex)
    alpha = ex / denom[dst]
    out = torch.zeros(n, h.shape[1], dtype=x.dtype, device=x.device
                      ).index_add(0, dst, alpha[:, None] * h[src])
    if fault == "answer":
        k = max(1, n // 32)
        out = torch.cat([2.0 * out[:k], out[k:]])
    return out + p[prefix + "bias"]


def embed(p, prepared, layer_num, fault=None):
    x, n = p["x"], prepared["n"]
    for i in range(layer_num):
        outs = [_gat(p, f"layers.{i}.aggs.{m}.", x, s, d, n, fault)
                for m, (s, d) in enumerate(prepared["gat"])]
        h = torch.cat([x] + outs, dim=1)
        h = torch.tanh(h @ p[f"layers.{i}.linear.weight"].T
                       + p[f"layers.{i}.linear.bias"])
        x = h @ p[f"layers.{i}.linear1.weight"].T + \
            p[f"layers.{i}.linear1.bias"]
    return x


def _half(a):
    """The first half of the edges of [2, E] pairs or [E] weights."""
    return a[..., :a.shape[-1] // 2]


def loss(p, z, prepared, config, fault=None):
    pos, neg = prepared["pos"], prepared["neg"]
    c_pos, c_neg = prepared["c_pos"], prepared["c_neg"]
    if fault == "half":
        pos, neg, c_pos, c_neg = (_half(a) for a in (pos, neg, c_pos, c_neg))
    softplus = torch.nn.functional.softplus

    def dot(e):
        return (z[e[0]] * z[e[1]]).sum(dim=1)

    sign = softplus(-dot(pos)).sum() + softplus(dot(neg)).sum()

    def score(k, rows):
        w = p[f"loss_direction.score_function{k}.weight"]
        b = p[f"loss_direction.score_function{k}.bias"]
        return torch.sigmoid(rows @ w.T + b)[:, 0]

    def diff(e):
        return score(1, z[e[0]]) - score(2, z[e[1]])

    direction = (torch.clamp_min(diff(pos) + 0.5, 0.0) ** 2).sum() + \
        (torch.clamp_min(0.5 - diff(neg), 0.0) ** 2).sum()

    def tri(e):
        pair = torch.cat([z[e[0]], z[e[1]]], dim=1)
        return (pair @ p["loss_tri.linear.weight"].T
                + p["loss_tri.linear.bias"])[:, 0]

    triangle = (c_pos * softplus(-tri(pos))).sum() + \
        (c_neg * softplus(tri(neg))).sum()
    return sign + config["lamb_d"] * direction + config["lamb_t"] * triangle


def adamw_run(params, loss_fn, steps, lr, weight_decay, fault=None):
    """``steps`` steps of AdamW (the decay scales the parameters before
    the Adam update, apart from the gradient).  Returns (losses, the
    first gradient, the change of every parameter after the steps)."""
    b1, b2 = common.ADAM_BETAS
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    s = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first = [], None
    for t in range(1, steps + 1):
        value = loss_fn(p)
        grads = dict(zip(p, torch.autograd.grad(value, list(p.values()))))
        losses.append(float(value.detach()))
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        if fault == "state":
            continue
        with torch.no_grad():
            for k, g in grads.items():
                p[k].mul_(1.0 - lr * weight_decay)
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                s[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mhat = m[k] / (1 - b1 ** t)
                vhat = s[k] / (1 - b2 ** t)
                p[k].sub_(lr * mhat / (vhat.sqrt() + common.ADAM_EPS))
    change = {k: p[k].detach() - params[k] for k in p}
    return losses, first, change


def train(config: dict, prepared: dict, inputs: dict, params: dict,
          steps: int, fault=None):
    """``steps`` full-batch steps from ``params`` and the drawn embedding:
    (losses, first gradient, change).  ``fault``: "half" (each loss over
    the first half of its positive and of its negative edges), "answer"
    (the first 1/32 of the rows of every attention aggregate doubled) or
    "state" (AdamW leaves the parameters unchanged)."""
    common.set_full_float32()
    dtype, device = prepared["dtype"], prepared["pos"].device
    p0 = {k: v.to(dtype) for k, v in params.items()}
    p0["x"] = input_embedding(prepared["n"], config["in_dim"], inputs,
                              device).to(dtype)

    def loss_fn(p):
        z = embed(p, prepared, config["layer_num"], fault)
        return loss(p, z, prepared, config, fault)

    return adamw_run(p0, loss_fn, steps, config["lr"],
                     config["weight_decay"], fault)
