"""Plain DIGRAC (He et al., LoG 2022): two-layer MLPs for the source and
target embeddings (dropout between their layers, ``common.Dropout``,
source then target), DIMPA's hop-weighted walks, a linear head to cluster
probabilities, trained on the probabilistic imbalance loss.

Walks: P_s = D^-1 (A + f I) and P_t = D_t^-1 (A^T + f I), A with
duplicate edges summed, f added at every node without a self-loop, D the
row sums; P x sums at the source.  DIMPA: feat_s = sum_h w_s[h] P_s^h x_s
(h = 0..hop), feat_t likewise, z = [feat_s | feat_t].  Probabilities:
softmax(z W + b).  Loss (vol_sum, sort): W = P^T A P, vol = column sums
of A P + A^T P, for each pair k < l the flow imbalance
|W_kl - W_lk| / (vol_k + vol_l + 1e-8) * 2 (0 where W_kl = W_lk), and
1 - the mean of the ``sel`` largest.  Adam with coupled L2.
"""
import numpy as np
import scipy.sparse as sp
import torch

from port_bench.reference import common

EPS = 1e-8


def param_spec(config: dict):
    h, f, k = config["hidden"], config["num_features"], config["num_clusters"]
    gain = 2.0  # DIGRAC's xavier-uniform gain 1.414, squared
    spec = []
    for side in ("s", "t"):
        spec.append((f"w_{side}0.weight", (h, f), "glorot", gain))
        spec.append((f"w_{side}1.weight", (h, h), "glorot", gain))
    spec.append(("dimpa._w_s", (config["hop"] + 1, 1), "one_plus", 0.5))
    spec.append(("dimpa._w_t", (config["hop"] + 1, 1), "one_plus", 0.5))
    spec.append(("W_prob", (2 * h, k), "glorot", gain))
    spec.append(("bias", (k,), "uniform", 0.1))
    return spec


def _walk(A: sp.csr_matrix, fill: float) -> sp.csr_matrix:
    n = A.shape[0]
    loops = np.where(A.diagonal() == 0, fill, 0.0)
    Af = (A + sp.diags(loops)).tocsr()
    deg = np.asarray(Af.sum(axis=1)).ravel()
    dinv = np.zeros(n)
    dinv[deg != 0] = 1.0 / deg[deg != 0]
    return (sp.diags(dinv) @ Af).tocsr()


def operators(graph: dict, fill: float, device, dtype):
    """(P_s, P_t, A, A^T) as ``common.Operator``s."""
    ei, n = graph["edge_index"], graph["num_nodes"]
    w = np.asarray(graph["edge_weight"], np.float64)
    A = sp.csr_matrix((w, (ei[0], ei[1])), shape=(n, n))
    A.sum_duplicates()
    At = A.T.tocsr()
    return tuple(common.Operator(m, device, dtype)
                 for m in (_walk(A, fill), _walk(At, fill), A, At))


def probabilities(p, x, P_s, P_t, hop, drop, fault=None):
    x_s = drop(torch.relu(x @ p["w_s0.weight"].T)) @ p["w_s1.weight"].T
    x_t = drop(torch.relu(x @ p["w_t0.weight"].T)) @ p["w_t1.weight"].T
    ws, wt = p["dimpa._w_s"], p["dimpa._w_t"]
    feat_s, feat_t = ws[0] * x_s, wt[0] * x_t
    cs, ct = x_s, x_t
    for h in range(1, hop + 1):
        cs, ct = common.apply(P_s, cs, fault), common.apply(P_t, ct, fault)
        feat_s = feat_s + ws[h] * cs
        feat_t = feat_t + wt[h] * ct
    z = torch.cat([feat_s, feat_t], dim=1)
    return torch.softmax(z @ p["W_prob"] + p["bias"], dim=1)


def imbalance_loss(P, A, At, sel, fault=None):
    k = P.shape[1]
    AP, ATP = common.apply(A, P, fault), common.apply(At, P, fault)
    vol = (AP + ATP).sum(dim=0)
    W = P.T @ AP
    iu, ju = torch.triu_indices(k, k, offset=1, device=P.device)
    diff = (W[iu, ju] - W[ju, iu]).abs()
    curr = diff / (vol[iu] + vol[ju] + EPS) * 2
    curr = torch.where(diff != 0, curr, torch.zeros_like(curr))
    top = torch.sort(curr, descending=True).values[:sel]
    return 1.0 - top.sum() / sel


def prepare(config: dict, graph: dict, device, dtype=torch.float64):
    """The walks, A and A^T, and the features, from the edge list."""
    loss = config["loss"]
    if (loss["normalization"], loss["threshold"]) != ("vol_sum", "sort"):
        raise ValueError("the reference computes vol_sum with sort only")
    common.set_full_float32()
    P_s, P_t, A, At = operators(graph, config["fill_value"], device, dtype)
    x = torch.from_numpy(common.degree_features(graph)).to(device, dtype)
    return dict(P_s=P_s, P_t=P_t, A=A, At=At, x=x, dtype=dtype)


def train(config: dict, prepared: dict, inputs: dict, params: dict,
          steps: int, fault=None):
    """``steps`` training steps from ``params``: (losses, first gradient,
    change) as ``common.adam_run`` returns them.  ``fault``: "half" (the
    loss sees the probabilities of the first half of the nodes only),
    "answer" (``common.apply``'s) or "state" (Adam leaves the parameters
    unchanged)."""
    x, dtype = prepared["x"], prepared["dtype"]
    n = x.shape[0]
    half = (torch.arange(n, device=x.device) < n // 2).to(dtype)[:, None]
    p0 = {k: v.to(dtype) for k, v in params.items()}
    drop = common.Dropout(config["dropout"], inputs["dropout_seed"],
                          x.device)

    def loss_fn(p):
        P = probabilities(p, x, prepared["P_s"], prepared["P_t"],
                          config["hop"], drop, fault)
        if fault == "half":
            P = P * half
        return imbalance_loss(P, prepared["A"], prepared["At"],
                              config["loss"]["sel"], fault)

    return common.adam_run(p0, loss_fn, steps, config["lr"],
                           config["weight_decay"], fault)
