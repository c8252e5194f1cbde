"""Synthetic graphs written in the real datasets' own file formats.

No dataset file ships with the repository.  These writers make a graph
with planted classes at a dataset's published size and save it as that
dataset's loader (``data/load_real.py``) reads it, so every real-data
entry point can run end to end without a download:

* ``write_citation``: ``cora_ml.npz`` / ``citeseer.npz`` — CSR arrays
  ``adj_*`` and ``attr_*`` (sparse binary bag-of-words rows) and
  ``labels``;
* ``write_telegram``: ``telegram/telegram_adj.npz`` (weighted, a scipy
  ``save_npz`` CSR) and ``telegram/telegram_labels.npy``;
* ``write_signed_csv``: ``bitcoin_alpha.csv`` and the other SDGNN CSVs —
  ``source,target,rating`` rows, node ids that are not 0..n-1;
* ``write_sssnet``: ``<Dir>/<name>_adj.npz`` (signed) and
  ``<name>_labels.npy`` (sampson, ppi, ...);
* ``write_digrac``: ``<name>.npz`` (blog, migration, ...).

Every writer takes a seed and draws from ``numpy.random.default_rng``.
"""
import os
from typing import Optional

import numpy as np
import scipy.sparse as sp

# published sizes: (nodes, edges, classes, features)
CORA_ML = dict(num_nodes=2995, num_edges=8416, num_classes=7,
               num_features=2879)
CITESEER = dict(num_nodes=3312, num_edges=4715, num_classes=6,
                num_features=3703)
TELEGRAM = dict(num_nodes=245, num_edges=8912, num_classes=4)
BITCOIN_ALPHA = dict(num_nodes=3783, num_pos=22650, num_neg=1536)
SAMPSON = dict(num_nodes=25, num_edges=200, num_classes=4)
BLOG = dict(num_nodes=1222, num_edges=19024)


def _planted_edges(labels: np.ndarray, num_edges: int, rng,
                   p_in: float = 0.8):
    """``num_edges`` distinct directed pairs without self-loops, in draw
    order: a uniform source, and with probability ``p_in`` a target of
    the source's class, else a uniform one."""
    n = len(labels)
    num_edges = min(num_edges, n * (n - 1))
    members = [np.nonzero(labels == c)[0] for c in range(labels.max() + 1)]
    keys = np.zeros(0, np.int64)
    while len(keys) < num_edges:
        m = 2 * (num_edges - len(keys)) + 16
        src = rng.integers(0, n, m)
        tgt = rng.integers(0, n, m)
        same = rng.random(m) < p_in
        for c, mem in enumerate(members):
            pick = same & (labels[src] == c)
            if len(mem):
                tgt[pick] = mem[rng.integers(0, len(mem), pick.sum())]
        cand = np.concatenate([keys, (src * n + tgt)[src != tgt]])
        _, first = np.unique(cand, return_index=True)
        keys = cand[np.sort(first)]
    keys = keys[:num_edges]
    return keys // n, keys % n


def _labels(num_nodes: int, num_classes: int, rng) -> np.ndarray:
    return rng.permutation(np.arange(num_nodes) % num_classes)


def write_citation(root: str, name: str = "cora_ml",
                   num_nodes: Optional[int] = None,
                   num_edges: Optional[int] = None,
                   num_classes: Optional[int] = None,
                   num_features: Optional[int] = None,
                   words_per_node: int = 18, seed: int = 0) -> str:
    """``<root>/<name>.npz`` in the citation schema; sizes default to the
    dataset's (cora_ml or citeseer).  A node's words come half from its
    class's share of the vocabulary, half from all of it."""
    size = dict(CORA_ML if name == "cora_ml" else CITESEER)
    for k, v in dict(num_nodes=num_nodes, num_edges=num_edges,
                     num_classes=num_classes,
                     num_features=num_features).items():
        if v is not None:
            size[k] = v
    n, k, f = size["num_nodes"], size["num_classes"], size["num_features"]
    rng = np.random.default_rng(seed)
    labels = _labels(n, k, rng)
    row, col = _planted_edges(labels, size["num_edges"], rng)
    adj = sp.csr_matrix((np.ones(len(row), np.float32), (row, col)),
                        shape=(n, n))
    share = max(f // k, 1)
    words = np.where(rng.random((n, words_per_node)) < 0.5,
                     (labels[:, None] * share
                      + rng.integers(0, share, (n, words_per_node))) % f,
                     rng.integers(0, f, (n, words_per_node)))
    attr = sp.csr_matrix((np.ones(words.size, np.float32),
                          (np.repeat(np.arange(n), words_per_node),
                           words.ravel())), shape=(n, f))
    attr.data[:] = 1.0  # repeated words count once
    path = os.path.join(root, f"{name}.npz")
    np.savez(path, adj_data=adj.data, adj_indices=adj.indices,
             adj_indptr=adj.indptr, adj_shape=np.array(adj.shape),
             attr_data=attr.data, attr_indices=attr.indices,
             attr_indptr=attr.indptr, attr_shape=np.array(attr.shape),
             labels=labels.astype(np.int64))
    return path


def write_telegram(root: str, num_nodes: int = TELEGRAM["num_nodes"],
                   num_edges: int = TELEGRAM["num_edges"],
                   num_classes: int = TELEGRAM["num_classes"],
                   seed: int = 0) -> str:
    """``<root>/telegram/`` with heavy-tailed interaction-count weights."""
    rng = np.random.default_rng(seed)
    labels = _labels(num_nodes, num_classes, rng)
    row, col = _planted_edges(labels, num_edges, rng)
    w = rng.geometric(0.2, len(row)).astype(np.float64)
    d = os.path.join(root, "telegram")
    os.makedirs(d, exist_ok=True)
    sp.save_npz(os.path.join(d, "telegram_adj.npz"),
                sp.csr_matrix((w, (row, col)), shape=(num_nodes, num_nodes)))
    np.save(os.path.join(d, "telegram_labels.npy"), labels.astype(np.int64))
    return d


def write_signed_csv(root: str, name: str = "bitcoin_alpha",
                     num_nodes: int = BITCOIN_ALPHA["num_nodes"],
                     num_pos: int = BITCOIN_ALPHA["num_pos"],
                     num_neg: int = BITCOIN_ALPHA["num_neg"],
                     seed: int = 0) -> str:
    """``<root>/<name>.csv``: ratings 1..10 on positive edges and
    -10..-1 on negative ones, node ids a shuffled range offset by 1,000
    (the loader numbers them in order of appearance); positive edges
    mostly within two planted factions."""
    fname = {"wiki": "wikirfa.csv"}.get(name, f"{name}.csv")
    rng = np.random.default_rng(seed)
    faction = _labels(num_nodes, 2, rng)
    row, col = _planted_edges(faction, num_pos + num_neg, rng, p_in=0.6)
    order = rng.permutation(len(row))
    row, col = row[order], col[order]
    friendly = faction[row] == faction[col]
    # the friendliest pairs take the positive ratings
    rank = np.argsort(~friendly, kind="stable")
    sign = np.empty(len(row), np.int64)
    sign[rank[:num_pos]] = 1
    sign[rank[num_pos:]] = -1
    rating = np.where(sign > 0, rng.integers(1, 11, len(row)),
                      rng.integers(-10, 0, len(row)))
    ids = rng.permutation(num_nodes) + 1000
    path = os.path.join(root, fname)
    with open(path, "w") as fh:
        fh.writelines(f"{ids[a]},{ids[b]},{r}\n"
                      for a, b, r in zip(row, col, rating))
    return path


def write_sssnet(root: str, name: str = "sampson",
                 num_nodes: int = SAMPSON["num_nodes"],
                 num_edges: int = SAMPSON["num_edges"],
                 num_classes: int = SAMPSON["num_classes"],
                 seed: int = 0) -> str:
    """``<root>/<Dir>/<name>_adj.npz`` (+1 within a class, -1 across) and
    ``<name>_labels.npy``."""
    dirmap = {"sampson": "Sampson", "ppi": "PPI", "sp1500": "SP1500",
              "rainfall": "rainfall", "wikirfa": "wikirfa"}
    d = os.path.join(root, dirmap.get(name, name))
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    labels = _labels(num_nodes, num_classes, rng)
    row, col = _planted_edges(labels, num_edges, rng, p_in=0.6)
    w = np.where(labels[row] == labels[col], 1.0, -1.0)
    sp.save_npz(os.path.join(d, f"{name}_adj.npz"),
                sp.csr_matrix((w, (row, col)), shape=(num_nodes, num_nodes)))
    np.save(os.path.join(d, f"{name}_labels.npy"), labels.astype(np.int64))
    return d


def write_digrac(root: str, name: str = "blog",
                 num_nodes: int = BLOG["num_nodes"],
                 num_edges: int = BLOG["num_edges"], num_classes: int = 2,
                 seed: int = 0) -> str:
    """``<root>/<name>.npz``: an unweighted digraph whose edges run from
    class c to class c + 1 (mod K) three times in four."""
    rng = np.random.default_rng(seed)
    labels = _labels(num_nodes, num_classes, rng)
    shifted = (labels + 1) % num_classes
    row, col = _planted_edges(labels, num_edges, rng, p_in=0.0)
    flip = rng.random(len(row)) < 0.75
    members = [np.nonzero(labels == c)[0] for c in range(num_classes)]
    for c, mem in enumerate(members):
        pick = flip & (shifted[row] == c)
        col[pick] = mem[rng.integers(0, len(mem), pick.sum())]
    keep = row != col
    A = sp.csr_matrix((np.ones(keep.sum()), (row[keep], col[keep])),
                      shape=(num_nodes, num_nodes))
    A.data[:] = 1.0
    path = os.path.join(root, f"{name}.npz")
    sp.save_npz(path, A)
    return path
