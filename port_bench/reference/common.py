"""What the plain references share: sparse operators as PyTorch CSR
tensors with their transposes, an apply whose backward is the
transposed apply, Adam as torch.optim.Adam computes it, parameters drawn
from the seed on the card, dropout masks drawn from the seed, and degree
features."""
import math
import warnings
from typing import Dict, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def set_full_float32():
    """Matrix products in full float32 (TF32 off), the configurations'
    stated precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Operator:
    """A scipy CSR matrix on ``device`` as a PyTorch CSR tensor, with its
    transpose for the backward."""

    def __init__(self, m: sp.csr_matrix, device, dtype):
        self.shape = m.shape
        self.fwd = _to_torch(m, device, dtype)
        self.bwd = _to_torch(m.T.tocsr(), device, dtype)


def _to_torch(m: sp.csr_matrix, device, dtype):
    m = m.tocsr()
    m.sort_indices()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support")
        return torch.sparse_csr_tensor(
            torch.from_numpy(m.indptr.astype(np.int64)),
            torch.from_numpy(m.indices.astype(np.int64)),
            torch.from_numpy(m.data.astype(np.float64)), size=m.shape,
            dtype=dtype, check_invariants=True).to(device)


class _Apply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op):
        ctx.op = op
        return torch.sparse.mm(op.fwd, x)

    @staticmethod
    def backward(ctx, g):
        return torch.sparse.mm(ctx.op.bwd, g.contiguous()), None


def apply(op: Operator, x: torch.Tensor, fault=None) -> torch.Tensor:
    """``op @ x``; with ``fault == "answer"`` the first 1/32 of the rows of
    the answer come out doubled, as a kernel that got them wrong would."""
    out = _Apply.apply(x, op)
    if fault == "answer":
        k = max(1, out.shape[0] // 32)
        out = torch.cat([2.0 * out[:k], out[k:]])
    return out


class Dropout:
    """Inverted dropout with masks drawn from ``seed``: each call draws one
    float32 uniform tensor of ``x``'s shape from a generator on ``x``'s
    device, keeps the entries whose draw is at least ``p`` and scales
    them by 1 / (1 - p).  The harness hands the program the same seed,
    and a forward that draws its masks in the same order and shapes from
    a generator so seeded gets the same masks (torch's generator gives
    the same numbers for the same seed, offset and shape, in a CUDA graph
    replay too)."""

    def __init__(self, p: float, seed: int, device):
        self.p = float(p)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if not self.p:
            return x
        u = torch.rand(x.shape, generator=self.gen, device=x.device,
                       dtype=torch.float32)
        return torch.where(u >= self.p, x / (1.0 - self.p),
                           torch.zeros_like(x))


def degree_features(graph: dict) -> np.ndarray:
    """[N, 2]: the row and column sums of |A| (the library's "in" and
    "out" degrees) over their largest, at least 1."""
    ei, w, n = graph["edge_index"], graph["edge_weight"], graph["num_nodes"]
    aw = np.abs(np.asarray(w, np.float64))
    x = np.stack([np.bincount(ei[0], aw, minlength=n),
                  np.bincount(ei[1], aw, minlength=n)], axis=1)
    return x / max(x.max(), 1.0)


def draw_params(spec: Sequence[Tuple[str, tuple, str, float]], seed: int,
                device) -> Dict[str, torch.Tensor]:
    """Float32 parameters from one uniform draw on ``device``: each
    ``(name, shape, kind, arg)`` is ``glorot`` (uniform over +-sqrt(6 arg
    / (fan_in + fan_out)) of the last two dims, arg the squared gain),
    ``uniform`` (over +-arg) or ``one_plus`` (over 1 +- arg)."""
    sizes = [math.prod(shape) for _, shape, _, _ in spec]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for (name, shape, kind, arg), size in zip(spec, sizes):
        v = u[at:at + size].view(shape)
        at += size
        if kind == "glorot":
            v = v * math.sqrt(6.0 * arg / (shape[-2] + shape[-1]))
        elif kind == "uniform":
            v = arg * v
        elif kind == "one_plus":
            v = 1.0 + arg * v
        else:
            raise ValueError(f"unknown init {kind!r}")
        out[name] = v.contiguous()
    return out


def adam_run(params: Dict[str, torch.Tensor], loss_fn, steps: int, lr: float,
             weight_decay: float, fault=None):
    """``steps`` steps of Adam with coupled L2 (the decay joins the
    gradient before the moments, as torch.optim.Adam's weight_decay).
    Returns (losses, the first step's gradient with its decay, the change
    of every parameter after the steps)."""
    b1, b2 = ADAM_BETAS
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    s = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first = [], None
    for t in range(1, steps + 1):
        loss = loss_fn(p)
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = {k: gk + weight_decay * p[k] for k, gk in zip(p, grads)}
            if first is None:
                first = {k: v.clone() for k, v in g.items()}
            if fault == "state":
                continue
            for k in p:
                m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                s[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                mhat = m[k] / (1 - b1 ** t)
                vhat = s[k] / (1 - b2 ** t)
                p[k].sub_(lr * mhat / (vhat.sqrt() + ADAM_EPS))
    change = {k: (p[k].detach() - params[k]) for k in p}
    return losses, first, change
