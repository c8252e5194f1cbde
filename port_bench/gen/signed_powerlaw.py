"""A signed power-law digraph with wedge closure.

Distinct directed pairs, each carrying one sign: ``positive`` +
``negative`` of them over ``nodes`` nodes.  A share ``1 -
closure_share`` are base pairs with Zipf(``alpha``) endpoints on both
ends, matched as stubs: ``stub_factor`` times the base pairs needed are
dealt out to the nodes by rank in proportion to the Zipf weights (a
fixed count a node, the same for every seed), the targets' stubs are
shuffled against the sources', and the pairs, in a shuffled order, are
kept at their first draw (self-pairs dropped) until the base pairs are
had.  The ranks are node ids through one permutation drawn from
``label_seed``, the same in every run, as a dataset's ids are.  So a
seed changes the wiring and the signs, and the degrees only by the
stubs left over and by the closures.  The rest close wedges: a base
pair u -> w drawn uniformly and an out-pair w -> v of the base set drawn
uniformly give u -> v (v != u, not a base pair, each kept at its first
draw; ``draw_factor`` times the closures needed are drawn).  The
``negative`` signs fall on a uniform subset of all pairs, independent of
the structure.

Every random number comes from ``np.random.default_rng(seed)`` (the
labels from ``label_seed``) on the host; given a ``device``, the
searches, deduplication and wedge lookups run there (in float64 and
int64) and give the same pairs as the host draw.
"""
import math

import numpy as np
import torch


def _zipf_cdf(n, alpha):
    w = (np.arange(1, n + 1, dtype=np.float64)) ** -alpha
    cdf = np.cumsum(w)
    return cdf / cdf[-1]


class _Host:
    """The generator's array operations in numpy."""

    def asarray(self, a):
        return np.asarray(a)

    def searchsorted(self, sorted_, v, right=False):
        return np.searchsorted(sorted_, v, side="right" if right else "left")

    def first_distinct(self, keys):
        """(distinct keys, the index of each one's first occurrence)."""
        return np.unique(keys, return_index=True)

    def sort(self, a):
        return np.sort(a)

    def floor_index(self, u, count):
        return np.floor(u * count).astype(np.int64)

    def minimum(self, a, m):
        return np.minimum(a, m)

    def cat(self, a, b):
        return np.concatenate([a, b])

    def host(self, a):
        return np.asarray(a)


class _Device:
    """The same operations in torch on ``device``."""

    def __init__(self, device):
        self.device = torch.device(device)

    def asarray(self, a):
        return torch.as_tensor(a, device=self.device)

    def searchsorted(self, sorted_, v, right=False):
        return torch.searchsorted(sorted_, v, right=right)

    def first_distinct(self, keys):
        uniq, inverse = torch.unique(keys, sorted=True, return_inverse=True)
        first = torch.full((len(uniq),), len(keys), dtype=torch.int64,
                           device=keys.device)
        first.scatter_reduce_(0, inverse, torch.arange(
            len(keys), device=keys.device), reduce="amin")
        return uniq, first

    def sort(self, a):
        return torch.sort(a).values

    def floor_index(self, u, count):
        return torch.floor(u * count).to(torch.int64)

    def minimum(self, a, m):
        return a.clamp(max=m)

    def cat(self, a, b):
        return torch.cat([a, b])

    def host(self, a):
        return a.cpu().numpy()


def _first_k(ops, keys, k, what):
    """The first ``k`` distinct keys of ``keys`` in draw order."""
    uniq, first = ops.first_distinct(keys)
    if len(uniq) < k:
        raise ValueError(f"{len(uniq)} distinct {what} drawn, {k} needed: "
                         "raise stub_factor or draw_factor")
    order = first.argsort()[:k]
    return uniq[order]


def stub_counts(n, alpha, stubs):
    """Stubs a node by rank: ``stubs`` dealt in proportion to the
    Zipf(``alpha``) weights (the floors of the cumulative shares)."""
    cum = np.floor(stubs * _zipf_cdf(n, alpha)).astype(np.int64)
    return np.diff(cum, prepend=0)


def signed_powerlaw(n, positive, negative, alpha, closure_share,
                    stub_factor, draw_factor, label_seed, seed, ops):
    """(row, col, sign) as ``ops`` arrays: the pairs in key order."""
    rng = np.random.default_rng(seed)
    total = positive + negative
    n_close = int(round(closure_share * total))
    n_base = total - n_close
    stubs = int(math.ceil(stub_factor * n_base))
    ranks = np.repeat(np.arange(n), stub_counts(n, alpha, stubs))
    order = rng.permutation(stubs)
    row = ops.asarray(ranks[order])
    col = ops.asarray(ranks[rng.permutation(stubs)][order])
    relabel = ops.asarray(np.random.default_rng(label_seed).permutation(n))
    keep = row != col
    row, col = relabel[row[keep]], relabel[col[keep]]
    base = _first_k(ops, row * n + col, n_base, "base pairs")
    base_sorted = ops.sort(base)             # by source, then target
    # wedges u -> w -> v
    draws = int(math.ceil(draw_factor * n_close))
    first = base[ops.floor_index(ops.asarray(rng.random(draws)), n_base)]
    u, w = first // n, first % n
    lo = ops.searchsorted(base_sorted, w * n)
    hi = ops.searchsorted(base_sorted, w * n + (n - 1), right=True)
    pick = ops.floor_index(ops.asarray(rng.random(draws)), hi - lo)
    has = hi > lo
    v = base_sorted[(lo + pick)[has]] % n
    u = u[has]
    cand = u * n + v
    at = ops.minimum(ops.searchsorted(base_sorted, cand), n_base - 1)
    in_base = base_sorted[at] == cand
    cand = cand[(u != v) & ~in_base]
    closed = _first_k(ops, cand, n_close, "closing pairs")
    sign = np.ones(total, np.int64)
    sign[rng.permutation(total)[:negative]] = -1
    keys = ops.cat(base, closed)
    order = keys.argsort()
    keys = keys[order]
    return keys // n, keys % n, ops.asarray(sign)[order]


def generate(traffic: dict, seed: int, device=None) -> dict:
    """The traffic's signed graph from ``seed``: ``edge_index`` [2, E]
    (the pairs in key order), ``edge_sign`` [E] (+1 / -1) and
    ``edge_weight`` (the sign as float32); drawn on the host, or, given a
    ``device``, the same pairs drawn there."""
    n = int(traffic["nodes"])
    ops = _Host() if device is None else _Device(device)
    row, col, sign = signed_powerlaw(
        n, int(traffic["positive"]), int(traffic["negative"]),
        float(traffic["alpha"]), float(traffic["closure_share"]),
        float(traffic["stub_factor"]), float(traffic["draw_factor"]),
        int(traffic["label_seed"]), seed, ops)
    sign = ops.host(sign)
    return dict(edge_index=np.vstack([ops.host(row), ops.host(col)]),
                edge_sign=sign, edge_weight=sign.astype(np.float32),
                num_nodes=n)
