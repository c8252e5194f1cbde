"""The port's real-data loaders vs the JAX package's, on files written in
each dataset's own schema (``data.schema_files``) into a directory of
the test's own: every array and split mask bit-equal (dtype included),
through each loader and both dispatchers; the ``processed/`` npz cache
round trip and ``PGSD_TPU_NO_CACHE``; a missing file raises
``FileNotFoundError`` once the download, stubbed to fail here, fails."""
import json
import os
import urllib.request

import numpy as np
import pytest

from pytorch_geometric_signed_directed_tpu.data import load_real as jx_load

from pytorch_geometric_signed_directed_tpu_torch.data import load_real
from pytorch_geometric_signed_directed_tpu_torch.data import schema_files

from test_torch_worker_memory import release_memory  # noqa: F401

FIELDS = ("edge_index", "edge_weight", "x", "y", "train_mask", "val_mask",
          "test_mask", "seed_mask", "stopping_mask")


def assert_same_data(a, b):
    assert a.num_nodes == b.num_nodes
    for k in FIELDS:
        va, vb = getattr(a, k, None), getattr(b, k, None)
        assert (va is None) == (vb is None), k
        if va is not None:
            va, vb = np.asarray(va), np.asarray(vb)
            assert va.dtype == vb.dtype, (k, va.dtype, vb.dtype)
            np.testing.assert_array_equal(va, vb, err_msg=k)


@pytest.fixture
def no_download(monkeypatch):
    """Any download attempt fails, as it does without network access."""
    def fail(url, target):
        raise OSError(f"no network for {url}")

    monkeypatch.setattr(urllib.request, "urlretrieve", fail)


@pytest.fixture
def root(tmp_path, monkeypatch, no_download):
    """Small schema files, the cache off and the search path cleared."""
    monkeypatch.setenv("PGSD_TPU_NO_CACHE", "1")
    monkeypatch.delenv("PGSD_TPU_DATA", raising=False)
    monkeypatch.setattr(jx_load, "_SEARCH_PATHS", ["", "datasets"])
    monkeypatch.chdir(tmp_path)
    r = str(tmp_path)
    schema_files.write_citation(r, "cora_ml", num_nodes=620, num_edges=1800,
                                num_classes=3, num_features=30)
    schema_files.write_citation(r, "citeseer", num_nodes=600,
                                num_edges=1200, num_classes=4,
                                num_features=25, seed=1)
    schema_files.write_telegram(r, num_nodes=50, num_edges=400,
                                num_classes=3)
    schema_files.write_signed_csv(r, num_nodes=90, num_pos=400, num_neg=60)
    schema_files.write_signed_csv(r, "wiki", num_nodes=70, num_pos=200,
                                  num_neg=50, seed=2)
    schema_files.write_sssnet(r, num_nodes=30, num_edges=150,
                              num_classes=3)
    schema_files.write_sssnet(r, "ppi", num_nodes=40, num_edges=200,
                              num_classes=2, seed=3)
    schema_files.write_digrac(r, num_nodes=80, num_edges=500)
    return r


LOADERS = {
    "cora_ml": lambda L, r: L.Cora_ml(r),
    "citeseer": lambda L, r: L.Citeseer(r),
    "telegram": lambda L, r: L.Telegram(r),
    "bitcoin_alpha": lambda L, r: L.SDGNN_real_data("bitcoin_alpha", r),
    "wiki": lambda L, r: L.SDGNN_real_data("wiki", r),
    "sampson": lambda L, r: L.SSSNET_real_data("sampson", r),
    "ppi": lambda L, r: L.SSSNET_real_data("ppi", r),
    "blog": lambda L, r: L.DIGRAC_real_data("blog", r),
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loader_bit_equal(root, name):
    assert_same_data(LOADERS[name](load_real, root),
                     LOADERS[name](jx_load, root))


def test_citation_masks_and_features(root):
    d = load_real.Cora_ml(root)
    assert d.x.shape == (620, 30) and d.x.dtype == np.float32
    assert set(np.unique(d.x)) <= {0.0, 1.0}
    assert d.train_mask.shape == (620, 10)
    # 20 a class for training, 500 for validation
    assert np.all(d.train_mask.sum(0) == 60)
    assert np.all(d.val_mask.sum(0) == 500)
    assert not np.any(d.train_mask & d.val_mask)


def test_signed_csv_numbers_nodes_in_order_of_appearance(root):
    d = load_real.SDGNN_real_data("bitcoin_alpha", root)
    with open(os.path.join(root, "bitcoin_alpha.csv")) as f:
        first = f.readline().strip().split(",")
    assert d.edge_index[:, 0].tolist() == [0, 1 if first[1] != first[0]
                                           else 0]
    assert d.edge_index.dtype == np.int64
    assert d.edge_weight.dtype == np.float32
    assert set(np.sign(d.edge_weight)) == {-1.0, 1.0}


def test_sampson_features_are_standardized(root):
    x = load_real.SSSNET_real_data("sampson", root).x
    from sklearn.preprocessing import StandardScaler

    feats = np.array([[1, 1, 1, 1, 1, 0, 0, 0, 1, 1, 1, 1, 0, 1, 1, 1, 1,
                       0, 0, 0, 0, 0, 0, 0, 0]], dtype=float).T
    np.testing.assert_array_equal(
        x, StandardScaler().fit_transform(feats).astype(np.float32))


def write_geom_gcn(root, name, n=30, splits=True):
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(4)
    y = rng.integers(0, 3, n)
    with open(os.path.join(d, "out1_node_feature_label.txt"), "w") as f:
        f.write("node_id\tfeature\tlabel\n")
        for i in range(n):
            feats = ",".join(str(v) for v in rng.integers(0, 2, 6))
            f.write(f"{i}\t{feats}\t{y[i]}\n")
    e = rng.integers(0, n, (90, 2))
    with open(os.path.join(d, "out1_graph_edges.txt"), "w") as f:
        f.write("node_id\tnode_id\n")
        for a, b in e:
            f.write(f"{a}\t{b}\n")
    if splits:
        for i in range(10):
            perm = rng.permutation(n)
            m = [np.isin(np.arange(n), perm[s]) for s in
                 (slice(0, 18), slice(18, 24), slice(24, n))]
            np.savez(os.path.join(d, f"{name}_split_0.6_0.2_{i}.npz"),
                     train_mask=m[0], val_mask=m[1], test_mask=m[2])


@pytest.mark.parametrize("name,splits", [("cornell", True),
                                         ("texas", False)])
def test_webkb_bit_equal(root, name, splits):
    """The geom-gcn schema, with its 10 split files or, without them,
    per-class splits once the download fails."""
    write_geom_gcn(root, name, splits=splits)
    assert_same_data(load_real.WebKB(name, root), jx_load.WebKB(name, root))


def test_wikics_bit_equal(root):
    n = 25
    rng = np.random.default_rng(5)
    raw = {"features": rng.normal(size=(n, 4)).tolist(),
           "labels": rng.integers(0, 3, n).tolist(),
           "links": [sorted(set(rng.integers(0, n, 3).tolist()))
                     for _ in range(n)],
           "train_masks": rng.integers(0, 2, (2, n)).astype(bool).tolist(),
           "val_masks": rng.integers(0, 2, (2, n)).astype(bool).tolist(),
           "stopping_masks": rng.integers(0, 2, (2, n)).astype(bool).tolist(),
           "test_mask": rng.integers(0, 2, n).astype(bool).tolist()}
    os.makedirs(os.path.join(root, "wikics"))
    with open(os.path.join(root, "wikics", "data.json"), "w") as f:
        json.dump(raw, f)
    assert_same_data(load_real.WikiCS(root), jx_load.WikiCS(root))


def test_msgnn_lead_lag_bit_equal(root):
    os.makedirs(os.path.join(root, "FiLL"))
    a = np.random.default_rng(6).normal(size=(12, 12))
    np.fill_diagonal(a, 0.0)
    np.save(os.path.join(root, "FiLL", "pvCLCL2000.npy"), a)
    for level in (1.0, 0.3):
        assert_same_data(
            load_real.MSGNN_real_data("FiLL-pvCLCL2000", root, level),
            jx_load.MSGNN_real_data("FiLL-pvCLCL2000", root, level))
    with pytest.raises(ValueError, match="Sparsify level"):
        load_real.MSGNN_real_data("FiLL-pvCLCL2000", root, 0.0)


@pytest.mark.parametrize("dataset", ["cora_ml", "citeseer", "telegram",
                                     "blog"])
def test_load_directed_real_data_bit_equal(root, dataset):
    """The dispatcher from the working directory (its default root "./"),
    with and without a node split of its own."""
    assert_same_data(load_real.load_directed_real_data(dataset),
                     jx_load.load_directed_real_data(dataset))
    kw = dict(train_size_per_class=5, val_size_per_class=5, seed=[4, 5, 6],
              data_split=3)
    if dataset != "blog":
        assert_same_data(load_real.load_directed_real_data(dataset, **kw),
                         jx_load.load_directed_real_data(dataset, **kw))


@pytest.mark.parametrize("dataset", ["bitcoin_alpha", "wiki", "sampson",
                                     "ppi"])
def test_load_signed_real_data_bit_equal(root, dataset):
    assert_same_data(load_real.load_signed_real_data(dataset),
                     jx_load.load_signed_real_data(dataset))


def test_dispatchers_reject_unknown_names(root):
    with pytest.raises(NameError):
        load_real.load_directed_real_data("no_such")
    with pytest.raises(NameError):
        load_real.load_signed_real_data("no_such")


def test_cache_round_trip(root, monkeypatch, tmp_path_factory):
    monkeypatch.delenv("PGSD_TPU_NO_CACHE")
    # a root that is not the working directory holds its own cache
    monkeypatch.chdir(tmp_path_factory.mktemp("elsewhere"))
    first = load_real.Telegram(root)
    path = os.path.join(root, "processed", "telegram.npz")
    assert os.path.isfile(path)
    with np.load(path) as z:
        assert set(z.files) == {"edge_index", "edge_weight", "x", "y",
                                "train_mask", "val_mask", "test_mask",
                                "seed_mask"}
    os.remove(os.path.join(root, "telegram", "telegram_adj.npz"))
    again = load_real.Telegram(root)  # from the cache alone
    assert_same_data(again, first)
    # the JAX package reads the same cache file
    assert_same_data(jx_load.Telegram(root), first)


def test_cache_under_pgsd_tpu_data(root, monkeypatch, tmp_path_factory):
    """Through a dispatcher (root "./"), the cache goes under
    $PGSD_TPU_DATA, read at call time; PGSD_TPU_NO_CACHE writes none."""
    data_dir = str(tmp_path_factory.mktemp("data"))
    schema_files.write_digrac(data_dir, num_nodes=60, num_edges=300)
    monkeypatch.setenv("PGSD_TPU_DATA", data_dir)
    monkeypatch.chdir(data_dir + "/..")
    load_real.load_directed_real_data("blog")
    assert not os.path.exists(os.path.join(data_dir, "processed"))
    monkeypatch.delenv("PGSD_TPU_NO_CACHE")
    a = load_real.load_directed_real_data("blog")
    assert os.path.isfile(os.path.join(data_dir, "processed",
                                       "digrac_blog.npz"))
    assert_same_data(load_real.load_directed_real_data("blog"), a)


@pytest.mark.parametrize("load", [
    lambda L, r: L.Cora_ml(r), lambda L, r: L.Telegram(r),
    lambda L, r: L.SDGNN_real_data("epinions", r),
    lambda L, r: L.SSSNET_real_data("rainfall", r),
    lambda L, r: L.DIGRAC_real_data("migration", r),
    lambda L, r: L.WikiCS(r)])
def test_a_missing_file_raises(tmp_path, monkeypatch, no_download, load):
    monkeypatch.setenv("PGSD_TPU_NO_CACHE", "1")
    monkeypatch.delenv("PGSD_TPU_DATA", raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="failed"):
        load(load_real, str(tmp_path))
