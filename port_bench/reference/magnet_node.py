"""Plain MagNet node classification (Zhang et al., NeurIPS 2021), in the
form of the original library's MagNetConv.

Operator: the magnetic Laplacian of the directed graph A (duplicate
edges summed, self-loops dropped) with sym normalization,
L = I - (D^-1/2 A_s D^-1/2) o exp(i Theta), A_s = (A + A^T) / 2, D the
row sums of A_s, Theta = 2 pi q (A - A^T), scaled to
L_hat = 2 L / lambda_max - I with lambda_max = 2.  The original's
propagate sums ``norm * x_j`` at the target, so it applies L_hat^T: a
real operator -N o cos(Theta) and an imaginary one N o sin(Theta) over
(i, j), with N = D^-1/2 A_s D^-1/2.

Layer (the original's four propagate streams, of which two repeat the
other two): S1_k = T_k(P_re) x_re, S2_k = T_k(P_im) x_im (Chebyshev
T_0 = x, T_1 = P x, T_k = 2 P T_{k-1} - T_{k-2}), out_re = sum_k
(S1_k - S2_k) W_k + b, out_im = sum_k (S1_k + S2_k) W_k + b, then the
complex ReLU (both parts kept where out_re >= 0).  Head: log_softmax of
a linear map of [out_re | out_im] under dropout (``common.Dropout``,
one mask a step).  Loss: the mean NLL over the training
mask; Adam with coupled L2.
"""
import numpy as np
import scipy.sparse as sp
import torch

from port_bench.reference import common


def param_spec(config: dict):
    K, h, f = config["K"], config["hidden"], config["num_features"]
    spec = []
    for layer in range(config["layers"]):
        fin = f if layer == 0 else h
        spec.append((f"convs.{layer}.weight", (K + 1, fin, h), "glorot", 1.0))
        spec.append((f"convs.{layer}.bias", (h,), "uniform", 0.1))
    spec.append(("linear.weight", (config["num_classes"], 2 * h), "glorot",
                 1.0))
    spec.append(("linear.bias", (config["num_classes"],), "uniform", 0.1))
    return spec


def operators(graph: dict, q: float, device, dtype):
    """(P_re, P_im) as ``common.Operator``s."""
    ei, n = graph["edge_index"], graph["num_nodes"]
    w = np.asarray(graph["edge_weight"], np.float64)
    keep = ei[0] != ei[1]
    A = sp.csr_matrix((w[keep], (ei[0][keep], ei[1][keep])), shape=(n, n))
    At = A.T.tocsr()
    U = (A + At).tocsr()
    U.sum_duplicates()
    U.sort_indices()
    T = (A - At).tocsr()
    T.sum_duplicates()
    T.eliminate_zeros()
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(U.indptr))
    key_u = rows * n + U.indices
    key_t = (np.repeat(np.arange(n, dtype=np.int64), np.diff(T.indptr)) * n
             + T.indices)
    at = np.searchsorted(key_u, key_t)
    if len(key_t) and not np.array_equal(key_u[at], key_t):
        raise ValueError("A - A^T has an entry outside A + A^T")
    theta = np.zeros(U.nnz)
    theta[at] = T.data
    s = U.data / 2.0
    deg = np.bincount(rows, weights=s, minlength=n)
    dinv = np.zeros(n)
    dinv[deg > 0] = deg[deg > 0] ** -0.5
    nrm = dinv[rows] * s * dinv[U.indices]
    ang = 2.0 * np.pi * q * theta

    def op(vals):
        return common.Operator(sp.csr_matrix((vals, U.indices, U.indptr),
                                             shape=(n, n)), device, dtype)

    return op(-nrm * np.cos(ang)), op(nrm * np.sin(ang))


def forward(p, x, P_re, P_im, config, drop, fault=None):
    K = config["K"]

    def cheb(P, v):
        ts = [v]
        if K >= 1:
            ts.append(common.apply(P, v, fault))
        for _ in range(2, K + 1):
            ts.append(2.0 * common.apply(P, ts[-1], fault) - ts[-2])
        return ts

    re, im = x, x
    for layer in range(config["layers"]):
        W, b = p[f"convs.{layer}.weight"], p[f"convs.{layer}.bias"]
        s1, s2 = cheb(P_re, re), cheb(P_im, im)
        o1 = sum(t @ W[k] for k, t in enumerate(s1))
        o2 = sum(t @ W[k] for k, t in enumerate(s2))
        re, im = o1 - o2 + b, o1 + o2 + b
        mask = (re >= 0).to(re.dtype)
        re, im = mask * re, mask * im
    z = drop(torch.cat([re, im], dim=1))
    return torch.log_softmax(z @ p["linear.weight"].T + p["linear.bias"], 1)


def prepare(config: dict, graph: dict, device, dtype=torch.float64):
    """The operators and features, from the edge list."""
    common.set_full_float32()
    P_re, P_im = operators(graph, config["q"], device, dtype)
    x = torch.from_numpy(common.degree_features(graph)).to(device, dtype)
    return dict(P_re=P_re, P_im=P_im, x=x, dtype=dtype)


def train(config: dict, prepared: dict, inputs: dict, params: dict,
          steps: int, fault=None):
    """``steps`` training steps from ``params``: (losses, first gradient,
    change) as ``common.adam_run`` returns them.  ``fault`` plants one of
    the faults the check must catch: "half" (the loss over half the
    training nodes), "answer" (``common.apply``'s) or "state" (Adam
    leaves the parameters unchanged)."""
    x, dtype = prepared["x"], prepared["dtype"]
    device = x.device
    y = torch.as_tensor(np.asarray(inputs["labels"]), device=device)
    mask = torch.as_tensor(inputs["masks"][0], device=device, dtype=dtype)
    if fault == "half":
        mask = mask * (torch.arange(len(mask), device=device)
                       < len(mask) // 2).to(dtype)
    p0 = {k: v.to(dtype) for k, v in params.items()}
    drop = common.Dropout(config["dropout"], inputs["dropout_seed"], device)

    def loss_fn(p):
        logp = forward(p, x, prepared["P_re"], prepared["P_im"], config,
                       drop, fault)
        nll = -logp[torch.arange(len(y), device=device), y] * mask
        return nll.sum() / torch.clamp_min(mask.sum(), 1.0)

    return common.adam_run(p0, loss_fn, steps, config["lr"],
                           config["weight_decay"], fault)
