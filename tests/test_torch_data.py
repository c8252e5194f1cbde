"""Port data containers, generators, samplers and splits vs the JAX
package: the same seeds and numpy inputs give the same arrays, compared
exactly (values and dtypes)."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pytorch_geometric_signed_directed_tpu.data import (
    DSBM as jx_DSBM, DirectedData as JxDirectedData, SDSBM as jx_SDSBM,
    SignedData as JxSignedData)
from pytorch_geometric_signed_directed_tpu.utils.general import (
    link_split as jx_link_split, node_split as jx_node_split)
from pytorch_geometric_signed_directed_tpu.utils.signed import (
    sampling as jx_sampling)

from pytorch_geometric_signed_directed_tpu_torch.data import (
    DSBM, DirectedData, SDSBM, SignedData)
from pytorch_geometric_signed_directed_tpu_torch.ops import coalesce
from pytorch_geometric_signed_directed_tpu_torch.utils import (
    meta_graph_generation)
from pytorch_geometric_signed_directed_tpu_torch.utils.general import (
    link_split, node_split)
from pytorch_geometric_signed_directed_tpu_torch.utils.signed import (
    sampling)

from test_torch_worker_memory import release_memory  # noqa: F401

TASKS = ["existence", "direction", "three_class_digraph", "sign",
         "four_class_signed_digraph", "five_class_signed_digraph"]
SIGNED = {"sign", "four_class_signed_digraph", "five_class_signed_digraph"}


def assert_same(a, b, path="out"):
    """Nested dicts / tuples of arrays equal in value and dtype."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype, (path, x.dtype, y.dtype)
        assert x.shape == y.shape, (path, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=path)


def digraph(n, e, seed, signed=False, loops=False):
    rng = np.random.default_rng(seed)
    row, col = rng.integers(0, n, e), rng.integers(0, n, e)
    if not loops:
        keep = row != col
        row, col = row[keep], col[keep]
    w = np.ones(len(row))
    if signed:
        w *= rng.choice([-1.0, 1.0], len(row))
    return np.stack([row, col]), w


def dsbm_graph(n=120, seed=0):
    F = meta_graph_generation("cyclic", 3, 0.05, False)
    return DSBM(n, 3, 0.2, F, rng=np.random.default_rng(seed))


def sdsbm_graph(n=120, seed=0):
    F = meta_graph_generation("cyclic", 3, 0.05, False)
    F[0, 1] = -abs(F[0, 1])
    return SDSBM(n, 3, 0.2, F, eta=0.1, rng=np.random.default_rng(seed))


# --- samplers --------------------------------------------------------------

@pytest.mark.parametrize("n,e,m", [(30, 200, None), (30, 200, 50),
                                   (12, 100, 20), (500, 3000, 4000)])
def test_negative_sampling_bit_equal(n, e, m):
    ei, _ = digraph(n, e, seed=n, loops=True)
    got = sampling.negative_sampling(ei, n, m, rng=np.random.default_rng(1))
    want = jx_sampling.negative_sampling(ei, n, m,
                                         rng=np.random.default_rng(1))
    assert_same(got, want)
    keys = set((ei[0] * n + ei[1]).tolist())
    assert not any(k in keys for k in (got[0] * n + got[1]).tolist())
    assert np.all(got[0] != got[1])


@pytest.mark.parametrize("n,e", [(20, 150), (200, 1500)])
def test_structured_negative_sampling_bit_equal(n, e):
    ei, _ = digraph(n, e, seed=e)
    got = sampling.structured_negative_sampling(
        ei, n, rng=np.random.default_rng(2))
    want = jx_sampling.structured_negative_sampling(
        ei, n, rng=np.random.default_rng(2))
    assert_same(got, want)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 17, 1000])
def test_shuffle_of_an_index_equals_the_shuffle_of_a_list(n):
    """RandomState.shuffle of a list of tuples and of a 1-D int64 index of
    the same length make the same draws and the same swaps, shuffle after
    shuffle: the rule link_class_split's arrays rest on."""
    pairs = [(i, 3 * i + 1) for i in range(n)]
    arr = np.asarray(pairs, np.int64).reshape(-1, 2)
    perm = np.arange(n)
    a, b = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(3):
        a.shuffle(pairs)
        b.shuffle(perm)
        np.testing.assert_array_equal(
            np.asarray(pairs, np.int64).reshape(-1, 2), arr[perm])
    assert a.randint(1 << 30) == b.randint(1 << 30)


@pytest.mark.parametrize("n,hi", [(0, 5), (1, 5), (50, 7), (5000, 10**9)])
def test_sort_unique_equals_np_unique(n, hi):
    keys = np.random.default_rng(n).integers(0, hi, n)
    assert_same(coalesce.sorted_unique(keys), np.unique(keys))


# --- node splits -----------------------------------------------------------

SPLIT_KW = [
    dict(train_size_per_class=0.6, val_size_per_class=0.2),
    dict(train_size_per_class=5, val_size_per_class=3,
         test_size_per_class=4, seed_size_per_class=2),
    dict(train_size=30, val_size=20, test_size=15, seed_size=5),
    dict(train_size=0.5, val_size=0.25, seed_size=0.5),
    dict(train_size_per_class=0.3, seed_size_per_class=0.5),
    dict(train_size=40),
]


@pytest.mark.parametrize("kw", SPLIT_KW)
def test_train_val_test_seed_split_bit_equal(kw):
    labels = np.random.default_rng(3).integers(0, 4, 150)
    args = dict(train_size_per_class=None, val_size_per_class=None,
                test_size_per_class=None, seed_size_per_class=None,
                train_size=None, val_size=None, test_size=None,
                seed_size=None)
    args.update(kw)
    got = node_split.get_train_val_test_seed_split(
        np.random.RandomState(4), labels, **args)
    want = jx_node_split.get_train_val_test_seed_split(
        np.random.RandomState(4), labels, **args)
    assert_same(got, want)


@pytest.mark.parametrize("kw", SPLIT_KW[:3])
def test_node_class_split_bit_equal(kw):
    _, y = dsbm_graph(150, seed=4)

    class D:
        pass

    got, want = D(), D()
    got.y = want.y = y
    node_split.node_class_split(got, data_split=3, **kw)
    jx_node_split.node_class_split(want, data_split=3, **kw)
    for name in ("train_mask", "val_mask", "test_mask", "seed_mask"):
        assert_same(getattr(got, name), getattr(want, name), name)
    assert got.train_mask.shape == (150, 3)


def test_sample_per_class_forbidden_and_forced():
    labels = np.random.default_rng(6).integers(0, 3, 60)
    forbidden = np.arange(0, 60, 4)
    force = np.arange(1, 60, 2)
    for kw in (dict(forbidden_indices=forbidden),
               dict(force_indices=force), {}):
        for size in (3, 0.4):
            assert_same(
                node_split.sample_per_class(np.random.RandomState(7), labels,
                                            size, **kw),
                jx_node_split.sample_per_class(np.random.RandomState(7),
                                               labels, size, **kw))


# --- link splits -----------------------------------------------------------

class Graph:
    def __init__(self, ei, w):
        self.edge_index, self.edge_weight = ei, w


def link_data(signed, seed, n=60):
    if signed:
        A, _ = sdsbm_graph(n, seed)
    else:
        A, _ = dsbm_graph(n, seed)
    A = A.tocoo()
    return Graph(np.vstack([A.row, A.col]).astype(np.int64), A.data)


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("maintain_connect,ratio", [(True, 1.0),
                                                    (False, 1.0),
                                                    (False, 0.6)])
def test_link_class_split_bit_equal(task, maintain_connect, ratio):
    data = link_data(task in SIGNED, seed=len(task))
    kw = dict(splits=3, task=task, seed=3, maintain_connect=maintain_connect,
              ratio=ratio)
    got = link_split.link_class_split(data, **kw)
    want = jx_link_split.link_class_split(data, **kw)
    assert_same(got, want)
    assert len(got[0]["train"]["edges"]) > 0


@pytest.mark.parametrize("task", ["three_class_digraph",
                                  "five_class_signed_digraph"])
def test_link_class_split_reads_the_data_adjacency(task):
    """A graph that carries its own ``A``, with repeated edges that ``A``
    sums: the same arrays as JAX."""
    data = link_data(task in SIGNED, seed=4)
    data.edge_index = np.hstack([data.edge_index, data.edge_index[:, :20]])
    data.edge_weight = np.r_[data.edge_weight, data.edge_weight[:20]]
    data.A = sp.coo_matrix((data.edge_weight, tuple(data.edge_index)),
                           shape=(60, 60))
    kw = dict(splits=2, task=task, seed=5, maintain_connect=False)
    assert_same(link_split.link_class_split(data, **kw),
                jx_link_split.link_class_split(data, **kw))


def test_link_class_split_spanning_forest_of_a_disconnected_graph():
    """Three components and isolated nodes: the forest's edges (in the
    set's order) go to train and stay out of val and test."""
    rng = np.random.default_rng(9)
    parts = []
    for lo, hi in ((0, 20), (20, 45), (45, 70)):
        r = rng.integers(lo, hi, 120)
        c = rng.integers(lo, hi, 120)
        parts.append(np.stack([r[r != c], c[r != c]]))
    ei = np.unique(np.hstack(parts), axis=1)
    data = Graph(ei, np.ones(ei.shape[1]))
    for task in ("direction", "existence"):
        kw = dict(size=80, splits=2, task=task, seed=1,
                  maintain_connect=True)
        assert_same(link_split.link_class_split(data, **kw),
                    jx_link_split.link_class_split(data, **kw))


@pytest.mark.parametrize("kw,match", [
    (dict(task="sign_and_direction"), "valid task"),
    (dict(maintain_connect=True, ratio=0.6), "maintain_connect"),
    (dict(maintain_connect=False, ratio=1.5), "smaller than 1.0"),
    (dict(maintain_connect=False, ratio=0.1), "prob_val"),
])
def test_link_class_split_rejects_bad_arguments(kw, match):
    with pytest.raises(ValueError, match=match):
        link_split.link_class_split(link_data(False, 1), **kw)


def test_link_class_split_places_on_a_torch_device():
    data = link_data(False, seed=2)
    got = link_split.link_class_split(data, splits=1, device="cpu")
    want = link_split.link_class_split(data, splits=1)
    for key in ("graph", "weights"):
        assert isinstance(got[0][key], torch.Tensor)
        np.testing.assert_array_equal(got[0][key].numpy(), want[0][key])
    for part in ("train", "val", "test"):
        for key in ("edges", "label"):
            assert got[0][part][key].device.type == "cpu"
            np.testing.assert_array_equal(got[0][part][key].numpy(),
                                          want[0][part][key])


@pytest.mark.parametrize("mode", [(True, False), (False, False),
                                  (True, True)])
@pytest.mark.parametrize("task", ["existence", "direction"])
def test_undirected_label2directed_label_bit_equal(mode, task):
    directed, signed = mode
    ei, w = digraph(25, 120, seed=11, signed=signed)
    A = sp.coo_matrix((w, (ei[0], ei[1])), shape=(25, 25)).tocsr()
    rng = np.random.default_rng(12)
    pairs = rng.integers(0, 25, (90, 2))
    got = link_split.undirected_label2directed_label(A, pairs, task,
                                                     directed, signed)
    want = jx_link_split.undirected_label2directed_label(
        A, [tuple(p) for p in pairs.tolist()], task, directed, signed)
    assert_same(got, want)
    assert_same(link_split.undirected_label2directed_label(A, [], task),
                jx_link_split.undirected_label2directed_label(A, [], task))


# --- generators and containers ---------------------------------------------

@pytest.mark.parametrize("eta", [0.0, 0.1, 0.3])
def test_sdsbm_bit_equal_signs_and_flips(eta):
    F = meta_graph_generation("cyclic", 3, 0.05, False)
    F[0, 1] = -abs(F[0, 1])
    A, y = SDSBM(300, 3, 0.1, F, eta=eta, rng=np.random.default_rng(4))
    B, z = jx_SDSBM(300, 3, 0.1, F, eta=eta, rng=np.random.default_rng(4))
    np.testing.assert_array_equal(y, z)
    assert_same((A.indptr, A.indices, A.data), (B.indptr, B.indices, B.data))
    # the unflipped graph: DSBM on |F| with the F < 0 block negated
    U, _ = DSBM(300, 3, 0.1, F, rng=np.random.default_rng(4))
    assert (abs(U) != abs(A)).nnz == 0
    flipped = int((U.multiply(A) < 0).sum())
    assert flipped == int(U.nnz * eta)
    rows, cols = U.nonzero()
    neg_block = (y[rows] == 0) & (y[cols] == 1)
    assert np.all(np.asarray(U[rows[neg_block], cols[neg_block]]) < 0)
    assert np.all(np.asarray(U[rows[~neg_block], cols[~neg_block]]) > 0)


def test_dsbm_draws_unchanged_by_the_shared_core():
    F = meta_graph_generation("cyclic", 5, 0.05, False)
    A, y = DSBM(400, 5, 0.05, F, 1.5, rng=np.random.default_rng(8))
    B, z = jx_DSBM(400, 5, 0.05, F, 1.5, rng=np.random.default_rng(8))
    np.testing.assert_array_equal(y, z)
    assert_same((A.indptr, A.indices, A.data), (B.indptr, B.indices, B.data))


def container_attrs(d):
    return {"edge_index": d.edge_index, "edge_weight": d.edge_weight,
            "num_nodes": np.int64(d.num_nodes), "y": d.y,
            "is_directed": np.bool_(d.is_directed),
            "is_weighted": np.bool_(d.is_weighted)}


def test_directed_data_matches_jax():
    A, y = dsbm_graph(90, seed=5)
    got, want = DirectedData(A=A, y=y), JxDirectedData(A=A, y=y)
    assert_same(container_attrs(got), container_attrs(want))
    ei, w = digraph(40, 200, seed=6)
    w = w * np.random.default_rng(6).uniform(0.5, 2.0, len(w))
    got = DirectedData(edge_index=ei, edge_weight=w)
    want = JxDirectedData(edge_index=ei, edge_weight=w)
    assert_same(container_attrs(got), container_attrs(want))
    assert got.is_weighted
    got.to_unweighted()
    want.to_unweighted()
    assert_same(container_attrs(got), container_attrs(want))
    got = DirectedData(edge_index=ei, init_data={"y": np.arange(3),
                                                 "extra": 7})
    assert got.extra == 7 and got.y.tolist() == [0, 1, 2]


def test_directed_data_splits_match_jax():
    A, y = dsbm_graph(90, seed=5)
    got, want = DirectedData(A=A, y=y), JxDirectedData(A=A, y=y)
    got.node_split(train_size_per_class=0.6, val_size_per_class=0.2)
    want.node_split(train_size_per_class=0.6, val_size_per_class=0.2)
    for name in ("train_mask", "val_mask", "test_mask", "seed_mask"):
        assert_same(getattr(got, name), getattr(want, name), name)
    for task in ("direction", "three_class_digraph"):
        assert_same(got.link_split(task=task, splits=1),
                    want.link_split(task=task, splits=1))
    with pytest.raises(ValueError, match="SignedData"):
        got.link_split(task="sign")


def test_signed_data_matches_jax():
    A, y = sdsbm_graph(90, seed=7)
    got, want = SignedData(A=A, y=y), JxSignedData(A=A, y=y)
    attrs = lambda d: dict(container_attrs(d),  # noqa: E731
                           is_signed=np.bool_(d.is_signed))
    assert_same(attrs(got), attrs(want))
    got.separate_positive_negative()
    want.separate_positive_negative()
    for name in ("edge_index_p", "edge_index_n", "edge_weight_p",
                 "edge_weight_n"):
        assert_same(getattr(got, name), getattr(want, name), name)
    assert (got.A_p != want.A_p).nnz == 0 and (got.A_n != want.A_n).nnz == 0
    got.clear_separate_attributes()
    assert not hasattr(got, "A_p")
    for task in ("sign", "four_class_signed_digraph",
                 "five_class_signed_digraph"):
        assert_same(got.link_split(task=task, splits=2),
                    want.link_split(task=task, splits=2))
    got.node_split(train_size_per_class=0.6, val_size_per_class=0.2)
    want.node_split(train_size_per_class=0.6, val_size_per_class=0.2)
    assert_same(got.test_mask, want.test_mask)

    # a (positive, negative) pair of adjacencies, and to_unweighted
    P = sp.random(30, 30, density=0.1, random_state=1, format="csr")
    N = sp.random(30, 30, density=0.1, random_state=2, format="csr")
    got, want = SignedData(A=(P, N)), JxSignedData(A=(P, N))
    assert_same(attrs(got), attrs(want))
    got.to_unweighted()
    want.to_unweighted()
    assert_same(attrs(got), attrs(want))


@pytest.mark.parametrize("cls,method", [
    (DirectedData, "set_hermitian_features"),
    (SignedData, "set_signed_Laplacian_features"),
    (SignedData, "set_spectral_adjacency_reg_features")])
def test_spectral_features_wait_for_their_module(cls, method):
    """Every feature setter is ported (tests/test_torch_digrac.py and
    tests/test_torch_signed.py hold the features against JAX's): each sets
    finite float32 features of the expected width."""
    A, y = sdsbm_graph(30, seed=1)
    data = cls(A=A, y=y)
    getattr(data, method)(k=2)
    width = 4 if method == "set_hermitian_features" else 2
    assert data.x.shape == (data.num_nodes, width)
    assert data.x.dtype == np.float32 and np.isfinite(data.x).all()
    assert not hasattr(data, "A_p")
