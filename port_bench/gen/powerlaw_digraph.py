"""A power-law digraph: Zipf(alpha) endpoints, self-loops dropped, node
ids randomly relabelled; with ``distinct`` in the traffic, each repeated
(source, target) pair kept once, so every edge has weight 1.

``powerlaw_digraph`` is a frozen copy of ``scripts/bench_giant.py``'s
generator (as ``chip_smoke.py`` and ``scripts/giant_digrac_torch.py``
use it): the same ``np.random.default_rng(seed)`` gives the same edges,
E=9,929,144 at seed 0 with 2,400,000 nodes and 10,000,000 draws.
``generate`` given a device draws the same edges there: the uniforms
and the relabelling come from the same ``np.random.default_rng(seed)``
stream, and the search of the cumulative weights, the relabelling and
the removal of repeated pairs run on the device, where they take
milliseconds in place of seconds of host time.  Labels, where the
traffic asks for them, are drawn from their own stream of the seed with
the traffic's class frequencies.
"""
import numpy as np
import torch


def powerlaw_digraph(n, e, alpha, seed):
    rng = np.random.default_rng(seed)
    w = (np.arange(1, n + 1, dtype=np.float64)) ** -alpha
    cdf = np.cumsum(w)
    cdf /= cdf[-1]

    def zipf_ids(k):
        return np.searchsorted(cdf, rng.random(k)).astype(np.int64)

    row, col = zipf_ids(e), zipf_ids(e)
    keep = row != col
    row, col = row[keep], col[keep]
    # random node relabeling: hubs land at arbitrary ids
    relabel = rng.permutation(n)
    return relabel[row], relabel[col]


def _zipf_cdf(n, alpha):
    w = (np.arange(1, n + 1, dtype=np.float64)) ** -alpha
    cdf = np.cumsum(w)
    return cdf / cdf[-1]


def powerlaw_digraph_on(n, e, alpha, seed, device, distinct=False):
    """``powerlaw_digraph``'s edges (each repeated pair once where
    ``distinct``), with the search, relabelling and deduplication on
    ``device``; host arrays."""
    rng = np.random.default_rng(seed)
    cdf = torch.from_numpy(_zipf_cdf(n, alpha)).to(device)

    def zipf_ids(k):
        return torch.searchsorted(cdf, torch.from_numpy(rng.random(k)).to(
            device))

    row, col = zipf_ids(e), zipf_ids(e)
    keep = row != col
    relabel = torch.from_numpy(rng.permutation(n)).to(device)
    row, col = relabel[row[keep]], relabel[col[keep]]
    if distinct:
        key = torch.unique(row * n + col)
        row, col = key // n, key % n
    return row.cpu().numpy(), col.cpu().numpy()


def generate(traffic: dict, seed: int, device=None) -> dict:
    """The traffic's graph from ``seed``: on the host, or, given a
    ``device``, the same edges drawn there."""
    n, e, alpha = int(traffic["nodes"]), int(traffic["draws"]), \
        float(traffic["alpha"])
    distinct = bool(traffic.get("distinct"))
    if device is not None:
        row, col = powerlaw_digraph_on(n, e, alpha, seed, device, distinct)
    else:
        row, col = powerlaw_digraph(n, e, alpha, seed)
        if distinct:
            key = np.unique(row * n + col)
            row, col = key // n, key % n
    out = dict(edge_index=np.vstack([row, col]),
               edge_weight=np.ones(len(row), np.float32), num_nodes=n)
    if "label_freq" in traffic:
        freq = np.asarray(traffic["label_freq"], np.float64)
        rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
        out["labels"] = rng.choice(len(freq), n, p=freq / freq.sum())
    return out
