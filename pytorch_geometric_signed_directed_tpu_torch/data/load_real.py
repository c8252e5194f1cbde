"""Real-dataset loaders and the name dispatchers.

Counterpart of ``pytorch_geometric_signed_directed_tpu/data/
load_real.py``: the same files, the same arrays (int64 edges in the same
order, float32 weights and features, int64 labels), the same split masks
and the same ``processed/<name>.npz`` cache (``PGSD_TPU_NO_CACHE=1``
turns it off).  Differences:

* the signed CSV loader takes the native tier's parse (``native``), with
  no pure-Python fallback;
* Sampson's features use the numpy standard scaler of
  ``spectral/features.py`` in place of scikit-learn's;
* ``PGSD_TPU_DATA`` is read at each call, not once at import.

Files are looked up in an explicit ``root``, then ``$PGSD_TPU_DATA``,
then ``./datasets``; a file found in none of them is downloaded from the
reference's published URLs, which needs network access, and a failed
download raises ``FileNotFoundError``.
"""
import json
import os
import urllib.request
from itertools import chain
from typing import List, Optional

import numpy as np
import scipy.sparse as sp

from .. import native
from ..spectral.features import standard_scale
from ..utils.general.node_split import node_class_split
from .directed_data import DirectedData
from .signed_data import SignedData

_BASE_URL = ("https://github.com/SherylHYX/pytorch_geometric_signed_directed/"
             "raw/main/datasets")


def _search_paths() -> List[str]:
    return [os.environ.get("PGSD_TPU_DATA", ""), "datasets"]


def _resolve(relpath: str, root: Optional[str] = None) -> str:
    """Find a raw dataset file locally or download it."""
    cands = ([root] if root else []) + _search_paths()
    for base in cands:
        if not base:
            continue
        p = os.path.join(base, relpath)
        if os.path.isfile(p):
            return p
    target_dir = os.path.join(root or "datasets", os.path.dirname(relpath))
    os.makedirs(target_dir, exist_ok=True)
    target = os.path.join(root or "datasets", relpath)
    url = f"{_BASE_URL}/{relpath}"
    try:
        urllib.request.urlretrieve(url, target)
    except Exception as e:  # no network: say where the file should be
        raise FileNotFoundError(
            f"Dataset file {relpath} not found in {cands} and download from "
            f"{url} failed ({e}). Place the file under $PGSD_TPU_DATA or "
            f"./datasets.") from e
    return target


def _coo_data(adj: sp.spmatrix):
    coo = adj.tocoo()
    edge_index = np.vstack([coo.row, coo.col]).astype(np.int64)
    return edge_index, coo.data.astype(np.float32)


# ---------------------------------------------------------------------------
# The processed-array cache: a loader's primitive arrays (edges, weights,
# features, labels, split masks) go to one npz beside the raw data, so a
# second construction reads one file.

_CACHE_FIELDS = ("edge_index", "edge_weight", "x", "y", "train_mask",
                 "val_mask", "test_mask", "seed_mask", "stopping_mask")


def _cache_path(name: str, root: Optional[str]) -> Optional[str]:
    if os.environ.get("PGSD_TPU_NO_CACHE"):
        return None
    # the dispatchers' default root "./" is the working directory, not a
    # dataset directory: fall through to $PGSD_TPU_DATA / ./datasets
    if root and os.path.abspath(root) == os.path.abspath("."):
        root = None
    for base in ([root] if root else []) + _search_paths():
        if not base:
            continue
        try:
            d = os.path.join(base, "processed")
            os.makedirs(d, exist_ok=True)
            return os.path.join(d, f"{name}.npz")
        except OSError:
            continue
    return None


def _cached(name: str, root: Optional[str], cls, build):
    """``cls`` rebuilt from the npz cache, or ``build()`` and saved."""
    path = _cache_path(name, root)
    if path and os.path.isfile(path):
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        data = cls(edge_index=arrays.pop("edge_index"),
                   edge_weight=arrays.pop("edge_weight", None),
                   x=arrays.pop("x", None), y=arrays.pop("y", None))
        for k, v in arrays.items():
            setattr(data, k, v)
        return data
    data = build()
    if path:
        arrays = {}
        for k in _CACHE_FIELDS:
            v = getattr(data, k, None)
            if v is not None:
                arrays[k] = np.asarray(v)
        tmp = path + ".tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    return data


def SDGNN_real_data(name: str, root: Optional[str] = None) -> SignedData:
    """CSV edge-list loader (bitcoin_alpha/otc, wiki, slashdot, epinions):
    rows ``source,target,sign``, nodes numbered in order of appearance."""
    return _cached(f"sdgnn_{name.lower()}", root, SignedData,
                   lambda: _sdgnn_build(name, root))


def _sdgnn_build(name: str, root: Optional[str]) -> SignedData:
    fname = {"bitcoin_alpha": "bitcoin_alpha.csv",
             "bitcoin_otc": "bitcoin_otc.csv",
             "wiki": "wikirfa.csv",
             "slashdot": "slashdot.csv",
             "epinions": "epinions.csv"}[name.lower()]
    rows, cols, w, _ = native.parse_signed_csv(_resolve(fname, root))
    return SignedData(edge_index=np.vstack([rows, cols]), edge_weight=w)


def SSSNET_real_data(name: str, root: Optional[str] = None) -> SignedData:
    """npz-adjacency + npy-labels loader (sampson, wikirfa, rainfall,
    sp1500, ppi, fin_ynet20xx)."""
    return _cached(f"sssnet_{name.lower()}", root, SignedData,
                   lambda: _sssnet_build(name, root))


def _sssnet_build(name: str, root: Optional[str]) -> SignedData:
    lname = name.lower()
    dirmap = {"sampson": "Sampson", "ppi": "PPI", "sp1500": "SP1500",
              "rainfall": "rainfall", "wikirfa": "wikirfa"}
    d = dirmap.get(lname, "Fin_YNet" if lname[:8] == "fin_ynet" else lname)
    adj = sp.load_npz(_resolve(f"{d}/{lname}_adj.npz", root))
    labels = np.load(_resolve(f"{d}/{lname}_labels.npy", root))
    edge_index, edge_weight = _coo_data(adj)
    x = None
    if lname == "sampson":
        # Sampson's hand-coded 1-d feature, standardized
        feats = np.array([[1, 1, 1, 1, 1, 0, 0, 0, 1, 1, 1, 1, 0, 1, 1, 1, 1,
                           0, 0, 0, 0, 0, 0, 0, 0]], dtype=float).T
        x = standard_scale(feats).astype(np.float32)
    return SignedData(edge_index=edge_index, edge_weight=edge_weight,
                      y=labels.astype(np.int64), x=x)


def MSGNN_real_data(name: str, root: Optional[str] = None,
                    sparsify_level: float = 1.0) -> SignedData:
    """Dense .npy lead-lag matrices (FiLL-pvCLCL / FiLL-OPCL per year),
    entries below the top ``sparsify_level`` share of |a| set to 0."""
    if not (0 < sparsify_level <= 1):
        raise ValueError("Sparsify level should be greater than 0 and less "
                         f"than 1 but got {sparsify_level}!")
    return _cached(f"msgnn_{name.lower()}_s{sparsify_level}", root,
                   SignedData, lambda: _msgnn_build(name, root,
                                                    sparsify_level))


def _msgnn_build(name: str, root: Optional[str],
                 sparsify_level: float) -> SignedData:
    fname = name[5:] + ".npy"  # e.g. FiLL-pvCLCL2000 -> pvCLCL2000.npy
    adj = np.load(_resolve(f"FiLL/{fname}", root)).copy()
    if sparsify_level < 1:
        sorted_abs = np.sort(np.abs(adj).ravel())
        threshold = sorted_abs[-int(len(sorted_abs) * sparsify_level)]
        adj[np.abs(adj) < threshold] = 0
    edge_index, edge_weight = _coo_data(sp.csr_matrix(adj))
    return SignedData(edge_index=edge_index, edge_weight=edge_weight)


def DIGRAC_real_data(name: str, root: Optional[str] = None) -> DirectedData:
    """npz loader for blog / wikitalk / migration / lead_lag20xx."""

    def build():
        adj = sp.load_npz(_resolve(f"{name}.npz", root))
        edge_index, edge_weight = _coo_data(adj)
        return DirectedData(edge_index=edge_index, edge_weight=edge_weight)

    return _cached(f"digrac_{name.lower()}", root, DirectedData, build)


def Telegram(root: Optional[str] = None) -> DirectedData:
    """Telegram with its 60/20/20 per-class splits (10 of them) and
    N(0, 1) features from ``RandomState(0)``."""
    return _cached("telegram", root, DirectedData,
                   lambda: _telegram_build(root))


def _telegram_build(root: Optional[str]) -> DirectedData:
    A = sp.load_npz(_resolve("telegram/telegram_adj.npz", root))
    label = np.load(_resolve("telegram/telegram_labels.npy", root))
    rs = np.random.RandomState(seed=0)
    features = rs.normal(0, 1.0, (A.shape[0], 1)).astype(np.float32)
    edge_index, edge_weight = _coo_data(sp.csr_matrix(A))
    data = DirectedData(x=features, edge_index=edge_index,
                        edge_weight=edge_weight, y=label.astype(np.int64))
    node_class_split(data, train_size_per_class=0.6, val_size_per_class=0.2,
                     data_split=10)
    return data


def _citation(fname: str, root: Optional[str]) -> DirectedData:
    return _cached(fname.split(".")[0], root, DirectedData,
                   lambda: _citation_build(fname, root))


def _citation_build(fname: str, root: Optional[str]) -> DirectedData:
    with np.load(_resolve(fname, root), allow_pickle=True) as loader:
        loader = dict(loader)
        adj = sp.csr_matrix(
            (loader["adj_data"], loader["adj_indices"],
             loader["adj_indptr"]), shape=loader["adj_shape"])
        features = sp.csr_matrix(
            (loader["attr_data"], loader["attr_indices"],
             loader["attr_indptr"]), shape=loader["attr_shape"])
        labels = loader.get("labels")
    edge_index, edge_weight = _coo_data(adj)
    data = DirectedData(x=np.asarray(features.todense(), np.float32),
                        edge_index=edge_index, edge_weight=edge_weight,
                        y=np.asarray(labels, np.int64))
    node_class_split(data, train_size_per_class=20, val_size=500,
                     data_split=10)
    return data


def Cora_ml(root: Optional[str] = None) -> DirectedData:
    return _citation("cora_ml.npz", root)


def Citeseer(root: Optional[str] = None) -> DirectedData:
    return _citation("citeseer.npz", root)


_GEOM_GCN_URL = ("https://raw.githubusercontent.com/graphdml-uiuc-jlu/"
                 "geom-gcn/f1fc0d14b3b019c562737240d06ec83b07d16a8f")


def _fetch_url(url: str, relpath: str, root: Optional[str]) -> str:
    cands = ([root] if root else []) + _search_paths()
    for base in cands:
        if base and os.path.isfile(os.path.join(base, relpath)):
            return os.path.join(base, relpath)
    target = os.path.join(root or "datasets", relpath)
    os.makedirs(os.path.dirname(target), exist_ok=True)
    try:
        urllib.request.urlretrieve(url, target)
    except Exception as e:
        raise FileNotFoundError(
            f"{relpath} not found locally and download from {url} failed "
            f"({e}).") from e
    return target


def _geom_gcn(name: str, root: Optional[str]) -> DirectedData:
    """geom-gcn files: out1_node_feature_label.txt, out1_graph_edges.txt
    and 10 split npz files (WebKB, WikipediaNetwork); per-class 60/20/20
    splits where the split files are missing."""
    return _cached(f"geomgcn_{name}", root, DirectedData,
                   lambda: _geom_gcn_build(name, root))


def _geom_gcn_build(name: str, root: Optional[str]) -> DirectedData:
    nf = _fetch_url(f"{_GEOM_GCN_URL}/new_data/{name}/"
                    "out1_node_feature_label.txt",
                    f"{name}/out1_node_feature_label.txt", root)
    ef = _fetch_url(f"{_GEOM_GCN_URL}/new_data/{name}/out1_graph_edges.txt",
                    f"{name}/out1_graph_edges.txt", root)
    with open(nf) as f:
        rows = f.read().split("\n")[1:-1]
    x = np.asarray([[float(v) for v in r.split("\t")[1].split(",")]
                    for r in rows], np.float32)
    y = np.asarray([int(r.split("\t")[2]) for r in rows], np.int64)
    with open(ef) as f:
        rows = f.read().split("\n")[1:-1]
    edges = np.asarray([[int(v) for v in r.split("\t")] for r in rows],
                       np.int64).T
    # duplicates coalesced, unweighted
    keys = np.unique(edges[0] * len(y) + edges[1])
    edge_index = np.stack([keys // len(y), keys % len(y)])
    data = DirectedData(x=x, edge_index=edge_index, y=y)
    masks = {"train": [], "val": [], "test": []}
    try:
        for i in range(10):
            sf = _fetch_url(
                f"{_GEOM_GCN_URL}/splits/{name}_split_0.6_0.2_{i}.npz",
                f"{name}/{name}_split_0.6_0.2_{i}.npz", root)
            with np.load(sf) as tmp:
                masks["train"].append(tmp["train_mask"].astype(bool))
                masks["val"].append(tmp["val_mask"].astype(bool))
                masks["test"].append(tmp["test_mask"].astype(bool))
        data.train_mask = np.stack(masks["train"], 1)
        data.val_mask = np.stack(masks["val"], 1)
        data.test_mask = np.stack(masks["test"], 1)
    except FileNotFoundError:
        node_class_split(data, train_size_per_class=0.6,
                         val_size_per_class=0.2, data_split=10)
    return data


def WebKB(name: str = "Texas", root: Optional[str] = None) -> DirectedData:
    assert name.lower() in ("cornell", "texas", "wisconsin")
    return _geom_gcn(name.lower(), root)


def WikipediaNetwork(name: str, root: Optional[str] = None) -> DirectedData:
    assert name.lower() in ("chameleon", "squirrel")
    return _geom_gcn(name.lower(), root)


def WikiCS(root: Optional[str] = None) -> DirectedData:
    """WikiCS's JSON: features, labels, links and its 20 train/val/
    stopping masks and one test mask."""
    return _cached("wikics", root, DirectedData,
                   lambda: _wikics_build(root))


def _wikics_build(root: Optional[str]) -> DirectedData:
    path = _fetch_url("https://github.com/pmernyei/wiki-cs-dataset/raw/"
                      "master/dataset/data.json", "wikics/data.json", root)
    with open(path) as f:
        raw = json.load(f)
    x = np.asarray(raw["features"], np.float32)
    y = np.asarray(raw["labels"], np.int64)
    edges = list(chain(*[[(i, j) for j in js]
                         for i, js in enumerate(raw["links"])]))
    edge_index = np.asarray(edges, np.int64).T
    data = DirectedData(x=x, edge_index=edge_index, y=y)
    data.train_mask = np.asarray(raw["train_masks"], bool).T
    data.val_mask = np.asarray(raw["val_masks"], bool).T
    data.test_mask = np.asarray(raw["test_mask"], bool)
    data.stopping_mask = np.asarray(raw["stopping_masks"], bool).T
    return data


def _node_split(dataset, train_size, val_size, test_size, seed_size,
                train_size_per_class, val_size_per_class,
                test_size_per_class, seed_size_per_class, seed, data_split):
    if train_size is not None or train_size_per_class is not None:
        dataset.node_split(
            train_size=train_size, val_size=val_size, test_size=test_size,
            seed_size=seed_size, train_size_per_class=train_size_per_class,
            val_size_per_class=val_size_per_class,
            test_size_per_class=test_size_per_class,
            seed_size_per_class=seed_size_per_class, seed=seed,
            data_split=data_split)


def load_directed_real_data(dataset: str = "WebKB", root: str = "./",
                            name: str = "Texas",
                            transform=None, pre_transform=None,
                            train_size=None, val_size=None, test_size=None,
                            seed_size=None, train_size_per_class=None,
                            val_size_per_class=None, test_size_per_class=None,
                            seed_size_per_class=None, seed=None,
                            data_split: int = 10) -> DirectedData:
    """A directed dataset by name: citeseer, cora_ml, telegram, blog,
    wikitalk, migration, lead_lag*, webkb (``name`` cornell / texas /
    wisconsin), wikics, wikipedianetwork (``name`` chameleon /
    squirrel)."""
    lds = dataset.lower()
    if lds == "citeseer":
        data = Citeseer(root)
    elif lds == "cora_ml":
        data = Cora_ml(root)
    elif lds == "telegram":
        data = Telegram(root)
    elif lds in ("blog", "wikitalk", "migration") or lds[:8] == "lead_lag":
        data = DIGRAC_real_data(name=dataset, root=root)
    elif lds == "webkb":
        data = WebKB(name=name, root=root)
    elif lds == "wikics":
        data = WikiCS(root=root)
    elif lds == "wikipedianetwork":
        data = WikipediaNetwork(name=name, root=root)
    else:
        raise NameError("Please input the correct data set name instead of "
                        f"{dataset}!")
    if pre_transform is not None:
        data = pre_transform(data) or data
    directed_dataset = DirectedData(edge_index=data.edge_index,
                                    edge_weight=data.edge_weight,
                                    init_data=data)
    if transform is not None:
        directed_dataset = transform(directed_dataset) or directed_dataset
    _node_split(directed_dataset, train_size, val_size, test_size, seed_size,
                train_size_per_class, val_size_per_class, test_size_per_class,
                seed_size_per_class, seed, data_split)
    return directed_dataset


def load_signed_real_data(dataset: str = "epinions", root: str = "./",
                          transform=None, pre_transform=None,
                          train_size=None, val_size=None, test_size=None,
                          seed_size=None, train_size_per_class=None,
                          val_size_per_class=None, test_size_per_class=None,
                          seed_size_per_class=None, seed=None,
                          data_split: int = 10,
                          sparsify_level: float = 1.0) -> SignedData:
    """A signed dataset by name: bitcoin_otc, bitcoin_alpha, wiki,
    slashdot, epinions, sp1500, rainfall, sampson, wikirfa, ppi,
    fin_ynet*, fill-*."""
    lds = dataset.lower()
    if lds in ("bitcoin_otc", "bitcoin_alpha", "wiki", "slashdot",
               "epinions"):
        data = SDGNN_real_data(name=dataset, root=root)
    elif lds in ("sp1500", "rainfall", "sampson", "wikirfa", "ppi") \
            or lds[:8] == "fin_ynet":
        data = SSSNET_real_data(name=dataset, root=root)
    elif lds[:4] == "fill":
        data = MSGNN_real_data(name=dataset, root=root,
                               sparsify_level=sparsify_level)
    else:
        raise NameError("Please input the correct data set name instead of "
                        f"{dataset}!")
    if pre_transform is not None:
        data = pre_transform(data) or data
    signed_dataset = SignedData(edge_index=data.edge_index,
                                edge_weight=data.edge_weight, init_data=data)
    if transform is not None:
        signed_dataset = transform(signed_dataset) or signed_dataset
    _node_split(signed_dataset, train_size, val_size, test_size, seed_size,
                train_size_per_class, val_size_per_class, test_size_per_class,
                seed_size_per_class, seed, data_split)
    return signed_dataset
