"""Link-level splitting: the six tasks of the original library.

Counterpart of ``pytorch_geometric_signed_directed_tpu/utils/general/
link_split.py``, on ``[E, 2]`` int64 arrays where the JAX package builds
Python lists of edge tuples (minutes of host time at 10^7 edges).  The
outputs are the same arrays, bit for bit, because every step keeps the
order the list code gives:

  * the lists are shuffled with ``RandomState.shuffle``; here a 1-D index
    ``perm`` takes the same shuffle and the arrays are gathered by it.
    The shuffle of a 1-D array and that of a list of the same length make
    the same ``random_interval`` draws and the same swaps
    (``tests/test_torch_data.py`` checks it);
  * the spanning forest's edges come out of a Python set of (i, j)
    tuples in its iteration order.  That order is CPython's for the same
    tuples inserted in the same sequence (tuple and int hashes do not
    depend on ``PYTHONHASHSEED``), so this module builds the same set, of
    at most 2 (N - 1) tuples, and takes its order;
  * membership tests (``e not in mst_set``, ``np.isin`` on the set's
    list) are ``np.isin`` on int64 keys ``i * n + j``, which keeps the
    order of the tested edges.
"""
from typing import Tuple

import numpy as np
import scipy.sparse as sp

from ...ops.coalesce import sorted_unique
from ..signed.sampling import negative_sampling


def _pairs_to_keys(pairs: np.ndarray, n: int) -> np.ndarray:
    return pairs[:, 0].astype(np.int64) * n + pairs[:, 1].astype(np.int64)


def _keys_to_pairs(keys: np.ndarray, n: int) -> np.ndarray:
    return np.stack([keys // n, keys % n], axis=1).astype(np.int64)


def _lookup(A: sp.csr_matrix, pairs: np.ndarray) -> np.ndarray:
    if len(pairs) == 0:
        return np.zeros(0)
    return np.asarray(A[pairs[:, 0], pairs[:, 1]]).ravel()


def _pairs(a) -> np.ndarray:
    return np.asarray(a, dtype=np.int64).reshape(-1, 2)


def undirected_label2directed_label(
    A: sp.csr_matrix, edge_pairs, task: str, directed_graph: bool = True,
    signed_directed: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Label query pairs ``[Q, 2]`` by their relation to the adjacency.

    Returns (new_edge_pairs, labels, label_weight, undirected_pairs), with
    the label of each task as ``link_class_split`` documents it."""
    edge_pairs = _pairs(edge_pairs)
    if len(edge_pairs) == 0:
        return (np.zeros((0, 2), np.int64), np.zeros(0, np.int32),
                np.zeros(0), np.zeros((0, 2), np.int64))
    n = A.shape[0]
    w_ij = _lookup(A, edge_pairs)
    w_ji = _lookup(A, edge_pairs[:, [1, 0]])

    if signed_directed or directed_graph:
        if signed_directed:
            undirected_mask = (w_ij != 0) & (w_ji != 0)
        else:
            undirected_mask = (np.abs(w_ij) > 0) & (np.abs(w_ji) > 0)
        undirected = edge_pairs[undirected_mask]
        # unique keys per category, both-direction pairs removed
        keys = _pairs_to_keys(edge_pairs, n)
        und_keys = keys[undirected_mask]

        def uniq(mask):
            k = sorted_unique(keys[mask])
            return k[~np.isin(k, und_keys)] if len(und_keys) else k

        negative = _keys_to_pairs(
            sorted_unique(keys[(np.abs(w_ij) == 0) & (np.abs(w_ji) == 0)]), n)
    if signed_directed:
        dp = _keys_to_pairs(uniq(w_ij > 0), n)
        dn = _keys_to_pairs(uniq(w_ij < 0), n)
        new_edge_pairs = np.vstack([dp, dn, dp[:, [1, 0]], dn[:, [1, 0]],
                                    negative])
        labels = np.concatenate([
            np.zeros(len(dp), np.int32), np.ones(len(dn), np.int32),
            np.full(len(dp), 2, np.int32), np.full(len(dn), 3, np.int32),
            np.full(len(negative), 4, np.int32)])
        w_direct = np.concatenate([_lookup(A, dp), _lookup(A, dn)])
        label_weight = np.concatenate([w_direct, w_direct,
                                       np.zeros(len(negative))])
        if len(dp):
            assert label_weight[labels == 0].min() > 0
        if len(dn):
            assert label_weight[labels == 1].max() < 0
    elif directed_graph:
        directed = _keys_to_pairs(uniq(np.abs(w_ij) > 0), n)
        new_edge_pairs = np.vstack([directed, directed[:, [1, 0]], negative])
        labels = np.concatenate([
            np.zeros(len(directed), np.int32),
            np.ones(len(directed), np.int32),
            np.full(len(negative), 2, np.int32)])
        w_direct = _lookup(A, directed)
        label_weight = np.concatenate([w_direct, w_direct,
                                       np.zeros(len(negative))])
    else:
        undirected = np.zeros((0, 2), np.int64)
        labels = np.ones(len(edge_pairs), np.int32)
        labels[np.abs(w_ij) == 0] = 2
        labels[w_ij < 0] = 0
        new_edge_pairs = edge_pairs
        label_weight = w_ij

    if task == "existence":
        labels = labels.copy()
        labels[labels == 1] = 0
        labels[labels == 2] = 1

    return new_edge_pairs, labels, label_weight, undirected


def _forest_edges(und_edge_index: np.ndarray, size: int) -> np.ndarray:
    """Both directions of a minimum spanning forest's edges, in the order
    of the JAX package's set of tuples (see the module docstring)."""
    A_und = sp.coo_matrix(
        (np.ones(und_edge_index.shape[1]), (und_edge_index[0],
                                            und_edge_index[1])),
        shape=(size, size)).tocsr()
    forest = sp.csgraph.minimum_spanning_tree(A_und).tocoo()
    mst_set = set()
    for i, j in zip(forest.row.tolist(), forest.col.tolist()):
        mst_set.add((i, j))
        mst_set.add((j, i))
    return _pairs(list(mst_set))


def _keep(ids: np.ndarray, labels: np.ndarray, below: int):
    keep = labels < below
    return ids[keep], labels[keep]


def link_class_split(data, size: int = None, splits: int = 2,
                     prob_test: float = 0.15, prob_val: float = 0.05,
                     task: str = "direction", seed: int = 0,
                     maintain_connect: bool = True, ratio: float = 1.0,
                     device=None) -> dict:
    """Train/val/test link splits; returns
    ``{i: {'graph', 'weights', 'train'/'val'/'test': {'edges','label'}}}``.
    Labels by task:

      * existence: 0 edge exists, 1 doesn't.
      * direction: 0 (i,j) exists, 1 (j,i) exists.
      * three_class_digraph: 0 / 1 / 2 (neither).
      * sign: 0 negative, 1 positive.
      * four_class_signed_digraph: 0 pos, 1 neg, 2 reversed pos,
        3 reversed neg.
      * five_class_signed_digraph: + 4 (no edge either direction).

    ``device=None`` returns numpy arrays; any other value puts every array
    on that torch device."""
    if task not in ("existence", "direction", "three_class_digraph",
                    "four_class_signed_digraph", "five_class_signed_digraph",
                    "sign"):
        raise ValueError(
            "Please select a valid task from 'existence', 'direction', "
            "'three_class_digraph', 'four_class_signed_digraph', "
            "'five_class_signed_digraph', and 'sign'!")
    edge_index = np.asarray(data.edge_index)
    row, col = edge_index[0], edge_index[1]
    if size is None:
        size = int(max(row.max(), col.max())) + 1
    edge_weight = getattr(data, "edge_weight", None)
    if edge_weight is None:
        edge_weight = np.ones(len(row), np.float32)
    edge_weight = np.asarray(edge_weight)

    A = getattr(data, "A", None)
    if A is not None:
        A = A.tocsr()
    else:
        A = sp.coo_matrix((edge_weight, (row, col)), shape=(size, size),
                          dtype=np.float32).tocsr()

    len_val = int(prob_val * len(row))
    len_test = int(prob_test * len(row))
    signed_tasks = task not in ("existence", "direction", "three_class_digraph")
    if signed_tasks:
        pos_ratio = (A > 0).sum() / len(A.data)
        neg_ratio = 1 - pos_ratio
        len_val_pos = int(np.around(prob_val * len(row) * pos_ratio))
        len_val_neg = int(np.around(prob_val * len(row) * neg_ratio))
        len_test_pos = int(np.around(prob_test * len(row) * pos_ratio))
        len_test_neg = int(np.around(prob_test * len(row) * neg_ratio))

    # undirected edge set for negative sampling
    und_row = np.concatenate([row, col])
    und_col = np.concatenate([col, row])
    # (the unique 1-D keys; the JAX package's np.unique(axis=0) gives the
    # same array through a much slower structured sort)
    und_edge_index = sorted_unique(und_row.astype(np.int64) * size + und_col)
    und_edge_index = np.stack([und_edge_index // size, und_edge_index % size])
    rng = np.random.default_rng(seed)
    neg_edges = np.ascontiguousarray(
        negative_sampling(und_edge_index, size,
                          num_neg_samples=edge_index.shape[1], rng=rng).T)

    all_edges = _pairs(edge_index.T)
    if maintain_connect:
        if ratio != 1:
            raise ValueError("ratio should be 1.0 if maintain_connect=True")
        mst = _forest_edges(und_edge_index, size)
        nmst = all_edges[~np.isin(_pairs_to_keys(all_edges, size),
                                  _pairs_to_keys(mst, size))]
        if len(nmst) < (len_val + len_test):
            raise ValueError(
                "There are no enough edges to be removed for "
                "validation/testing. Please use a smaller prob_test or "
                "prob_val.")
    else:
        mst = np.zeros((0, 2), np.int64)
        nmst = all_edges

    rs = np.random.RandomState(seed)
    if not 0 < ratio <= 1.0:
        raise ValueError("ratio should be smaller than 1.0 and larger than 0")
    if not ratio > prob_val + prob_test:
        raise ValueError("ratio should be larger than prob_val + prob_test")
    max_samples = int(ratio * edge_index.shape[1]) + 1
    lo = len_test + len_val
    # the lists' in-place shuffles, as index permutations (module docstring)
    nmst_perm = np.arange(len(nmst))
    neg_perm = np.arange(len(neg_edges))
    datasets = {}
    for ind in range(splits):
        rs.shuffle(nmst_perm)
        rs.shuffle(neg_perm)
        nmst_s, neg_s = nmst[nmst_perm], neg_edges[neg_perm]

        if not signed_tasks:
            ids_test = np.vstack([nmst_s[:len_test], neg_s[:len_test]])
            ids_val = np.vstack([nmst_s[len_test:lo], neg_s[len_test:lo]])
            if lo < len(nmst_s):
                ids_train = np.vstack([nmst_s[lo:max_samples], mst,
                                       neg_s[lo:max_samples]])
            else:
                ids_train = np.vstack([mst, neg_s[lo:max_samples]])
            args = (task, task != "existence", False)
        else:
            wv = _lookup(A, nmst_s)
            pos_l, neg_l = nmst_s[wv > 0], nmst_s[wv < 0]
            lo_pos, lo_neg = len_test_pos + len_val_pos, len_test_neg + len_val_neg
            ids_test = np.vstack([pos_l[:len_test_pos], neg_l[:len_test_neg],
                                  neg_s[:len_test]])
            ids_val = np.vstack([pos_l[len_test_pos:lo_pos],
                                 neg_l[len_test_neg:lo_neg],
                                 neg_s[len_test:lo]])
            if lo < len(nmst_s):
                ids_train = np.vstack([pos_l[lo_pos:max_samples],
                                       neg_l[lo_neg:max_samples], mst,
                                       neg_s[lo:max_samples]])
            else:
                ids_train = np.vstack([mst, neg_s[lo:max_samples]])
            args = (task, False, False) if task == "sign" else \
                (task, True, True)

        ids_test, labels_test, _, _ = undirected_label2directed_label(
            A, ids_test, *args)
        ids_val, labels_val, _, _ = undirected_label2directed_label(
            A, ids_val, *args)
        ids_train, labels_train, _, undirected_train = (
            undirected_label2directed_label(A, ids_train, *args))

        below = {"direction": 2, "sign": 2,
                 "four_class_signed_digraph": 4}.get(task)
        if below is not None:
            ids_train, labels_train = _keep(ids_train, labels_train, below)
            ids_test, labels_test = _keep(ids_test, labels_test, below)
            ids_val, labels_val = _keep(ids_val, labels_val, below)

        # observed graph: train pairs whose (i, j) direction exists, plus
        # the removed both-direction pairs
        w_train = _lookup(A, ids_train)
        direct = np.abs(w_train) > 0
        observed_edges = ids_train[direct]
        observed_weight = w_train[direct]
        if len(undirected_train) > 0:
            observed_edges = np.vstack([observed_edges, undirected_train])
            observed_weight = np.concatenate(
                [observed_weight, _lookup(A, undirected_train)])

        assert edge_index.shape[1] >= len(observed_edges), (
            f"The original edge number is {edge_index.shape[1]} while the "
            f"observed graph has {len(observed_edges)} edges!")

        datasets[ind] = {
            "graph": observed_edges.T.astype(np.int64),
            "weights": observed_weight.astype(np.float32),
            "train": {"edges": ids_train.astype(np.int64),
                      "label": labels_train.astype(np.int64)},
            "val": {"edges": ids_val.astype(np.int64),
                    "label": labels_val.astype(np.int64)},
            "test": {"edges": ids_test.astype(np.int64),
                     "label": labels_test.astype(np.int64)},
        }
    if device is not None:
        import torch

        def place(d):
            return {k: place(v) if isinstance(v, dict)
                    else torch.from_numpy(np.ascontiguousarray(v)).to(device)
                    for k, v in d.items()}

        datasets = place(datasets)
    return datasets
