"""Port host tier vs the JAX package: the same numpy inputs give the same
arrays, compared exactly."""
import numpy as np
import pytest

import pytorch_geometric_signed_directed_tpu as jx
from pytorch_geometric_signed_directed_tpu.data import DSBM as jx_DSBM
from pytorch_geometric_signed_directed_tpu.graph import (
    in_out_degree as jx_in_out_degree)
from pytorch_geometric_signed_directed_tpu.ops.coalesce import (
    coalesce_edges as jx_coalesce_edges)
from pytorch_geometric_signed_directed_tpu.spectral import (
    magnet_propagators as jx_magnet_propagators,
    magnetic_laplacian as jx_magnetic_laplacian,
    magnetic_signed_laplacian as jx_magnetic_signed_laplacian)
from pytorch_geometric_signed_directed_tpu.utils import (
    meta_graph_generation as jx_meta_graph_generation)

from pytorch_geometric_signed_directed_tpu_torch.data import DSBM
from pytorch_geometric_signed_directed_tpu_torch.graph import in_out_degree
from pytorch_geometric_signed_directed_tpu_torch.ops.coalesce import (
    coalesce_edges)
from pytorch_geometric_signed_directed_tpu_torch.spectral import (
    magnet_propagators, magnetic_laplacian, magnetic_signed_laplacian)
from pytorch_geometric_signed_directed_tpu_torch.utils import (
    meta_graph_generation)

from test_torch_worker_memory import release_memory  # noqa: F401

assert jx  # the JAX package is the reference


def digraph(n, e, seed, signed=False):
    """Random digraph WITH duplicate edges and self-loops."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n, e)
    col = rng.integers(0, n, e)
    row[:10], col[:10] = row[10:20], col[10:20]   # duplicates
    col[20:25] = row[20:25]                       # self-loops
    w = rng.uniform(0.5, 2.0, e)
    if signed:
        w *= rng.choice([-1.0, 1.0], e)
    return np.stack([row, col]), w


def assert_same(a, b):
    assert len(a) == len(b)
    if isinstance(a[-1], float):
        # lambda_max: ARPACK starts from a random vector, so two calls of
        # the same eigsh differ in the last digits
        np.testing.assert_allclose(a[-1], b[-1], rtol=1e-9)
        a, b = a[:-1], b[:-1]
    for x, y in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(x, y)


def test_coalesce_edges_with_duplicates():
    rng = np.random.default_rng(0)
    row = rng.integers(0, 20, 400)
    col = rng.integers(0, 30, 400)
    v1 = rng.standard_normal(400)
    v2 = rng.integers(0, 5, 400)      # integer values sum in float64
    v3 = rng.standard_normal(400).astype(np.float32)
    out = coalesce_edges(row, col, v1, v2, v3, num_cols=30)
    assert len(out[0]) < 400
    assert_same(out, jx_coalesce_edges(row, col, v1, v2, v3, num_cols=30))
    assert_same(coalesce_edges([], [], np.zeros(0), num_cols=3),
                jx_coalesce_edges([], [], np.zeros(0), num_cols=3))


@pytest.mark.parametrize("size_ratio", [1, 1.5])
def test_dsbm_same_seed_same_graph(size_ratio):
    F = meta_graph_generation("cyclic", 5, 0.05, False)
    A, y = DSBM(500, 5, 0.04, F, size_ratio,
                rng=np.random.default_rng(3))
    B, z = jx_DSBM(500, 5, 0.04, F, size_ratio,
                   rng=np.random.default_rng(3))
    np.testing.assert_array_equal(y, z)
    assert (A != B).nnz == 0 and A.nnz == B.nnz > 0
    assert_same((A.indptr, A.indices, A.data), (B.indptr, B.indices, B.data))


@pytest.mark.parametrize("style,k,ambient", [
    ("path", 4, False), ("cyclic", 5, False), ("cyclic", 5, True),
    ("cyclic", 2, False), ("complete", 5, False), ("star", 5, False),
    ("star", 5, True), ("multipartite", 10, False),
    ("multipartite", 10, True)])
def test_meta_graph_generation(style, k, ambient):
    np.random.seed(7)       # 'complete' draws from numpy's global state
    F = meta_graph_generation(style, k, 0.1, ambient)
    np.random.seed(7)
    np.testing.assert_array_equal(
        F, jx_meta_graph_generation(style, k, 0.1, ambient))


@pytest.mark.parametrize("signed", [False, True])
def test_in_out_degree(signed):
    ei, w = digraph(40, 300, seed=1, signed=signed)
    got = in_out_degree(ei, 40, signed=signed, edge_weight=w)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(
        got, jx_in_out_degree(ei, 40, signed=signed, edge_weight=w))
    np.testing.assert_array_equal(in_out_degree(ei), jx_in_out_degree(ei))


@pytest.mark.parametrize("normalization", [None, "sym"])
@pytest.mark.parametrize("signed", [False, True])
def test_magnetic_laplacians(normalization, signed):
    ei, w = digraph(30, 200, seed=2, signed=signed)
    if signed:
        for absolute_degree in (True, False):
            assert_same(
                magnetic_signed_laplacian(
                    ei, w, normalization, 30, 0.2,
                    return_lambda_max=True, absolute_degree=absolute_degree),
                jx_magnetic_signed_laplacian(
                    ei, w, normalization, 30, 0.2,
                    return_lambda_max=True, absolute_degree=absolute_degree))
    else:
        for q in (0.0, 0.1, 0.25):
            assert_same(magnetic_laplacian(ei, w, normalization, 30, q),
                        jx_magnetic_laplacian(ei, w, normalization, 30, q))
        assert_same(
            magnetic_laplacian(ei, w, normalization, 30, 0.25, True),
            jx_magnetic_laplacian(ei, w, normalization, 30, 0.25, True))
    assert_same(magnetic_laplacian(ei, None, normalization),
                jx_magnetic_laplacian(ei, None, normalization))


@pytest.mark.parametrize("normalization", [None, "sym"])
@pytest.mark.parametrize("signed", [False, True])
def test_magnet_propagators_arrays(normalization, signed):
    """The (row, col, vre, vim) of the fused pair equal the JAX package's
    (segment tier: both keep the (row, col)-sorted edge list)."""
    n = 50
    ei, w = digraph(n, 400, seed=4, signed=signed)
    kw = dict(q=0.25, normalization=normalization, num_nodes=n,
              mode="segment", signed=signed)
    D = magnet_propagators(ei, w, device="cpu", **kw).dual
    J = jx_magnet_propagators(ei, w, **kw).dual
    nnz = D.row.numel()
    assert_same((D.row.numpy(), D.col.numpy()),
                (np.asarray(J.row)[:nnz].astype(np.int64),
                 np.asarray(J.col)[:nnz].astype(np.int64)))
    for got, want in ((D.val_a, J.val_a), (D.val_b, J.val_b)):
        if normalization is None:
            # scaled by an eigsh lambda_max, whose last digits vary from
            # call to call (random ARPACK start vector)
            np.testing.assert_allclose(got.numpy(), np.asarray(want)[:nnz],
                                       rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(want)[:nnz])
    assert np.all(np.asarray(J.row)[nnz:] == n)   # only padding beyond

    # the kernel tier holds the same entries in CSR form (one fixed
    # lambda_max, so both builds scale alike)
    D = magnet_propagators(ei, w, device="cpu", lambda_max=1.9, **kw).dual
    M = magnet_propagators(ei, w, device="cpu", lambda_max=1.9,
                           **dict(kw, mode="mxu")).dual
    rows = np.repeat(np.arange(n), np.diff(M.rowptr.numpy()))
    assert_same((rows, M.col.numpy().astype(np.int64), M.val_a.numpy(),
                 M.val_b.numpy()),
                (D.row.numpy(), D.col.numpy(), D.val_a.numpy(),
                 D.val_b.numpy()))


def test_magnet_propagators_dense_tier():
    n = 25
    ei, w = digraph(n, 120, seed=7)
    P_re, P_im = magnet_propagators(ei, w, num_nodes=n, mode="dense",
                                    device="cpu")
    J_re, J_im = jx_magnet_propagators(ei, w, num_nodes=n, mode="dense")
    np.testing.assert_array_equal(P_re.dense.numpy(), np.asarray(J_re.dense))
    np.testing.assert_array_equal(P_im.dense.numpy(), np.asarray(J_im.dense))
