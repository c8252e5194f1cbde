"""The port's graph builders (graph.py) and PPR builders (spectral/appr.py)
against the JAX package's: host arrays bit-equal, dtypes and entry order
included, on graphs with duplicate edges, self loops, isolated nodes and
dangling rows; and every builder's operator applied on the dense, segment
and kernel ("mxu") tiers, forward and transposed, against a float64 dense
reference built with ``np.add.at``, in both packages.  The layout knobs
are lowered on both packages' modules for one case, so that it streams
(the JAX package's Pallas kernels run in interpret mode on the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_signed_directed_tpu import graph as jx_graph
from pytorch_geometric_signed_directed_tpu.ops import spmm as jx_spmm
from pytorch_geometric_signed_directed_tpu.ops.pallas import scatter_mxu
from pytorch_geometric_signed_directed_tpu.spectral import appr as jx_appr

from pytorch_geometric_signed_directed_tpu_torch import graph
from pytorch_geometric_signed_directed_tpu_torch.ops import layout, spmm
from pytorch_geometric_signed_directed_tpu_torch.spectral import appr

from test_torch_worker_memory import release_memory  # noqa: F401

# f32 applies: both packages sum each row in their own order
F32_TOL = dict(rtol=1e-5, atol=1e-5)
TIERS = ["dense", "segment", "mxu"]


def assert_same(a, b, path="out"):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
        return
    x, y = np.asarray(a), np.asarray(b)
    assert x.dtype == y.dtype, (path, x.dtype, y.dtype)
    np.testing.assert_array_equal(x, y, err_msg=path)


def messy_graph(n=60, e=400, seed=0, weighted=True):
    """Duplicate edges, a few self loops, isolated nodes (the last five)
    and dangling rows (nodes 0-4 have no out-edges)."""
    rng = np.random.default_rng(seed)
    row = rng.integers(5, n - 5, e)
    col = rng.integers(0, n - 5, e)
    row[:40], col[:40] = row[40:80], col[40:80]          # duplicates
    row[80:86] = col[80:86] = rng.integers(5, n - 5, 6)  # self loops
    w = (rng.uniform(0.5, 2.0, e) if weighted
         else np.ones(e)).astype(np.float32)
    return np.stack([row, col]).astype(np.int64), w, n


GRAPHS = {"weighted": dict(seed=0), "unweighted": dict(seed=1,
                                                       weighted=False)}


@pytest.fixture(params=sorted(GRAPHS))
def g(request):
    return messy_graph(**GRAPHS[request.param])


# --- host arrays -------------------------------------------------------------

def test_coalesce_and_to_undirected(g):
    ei, w, n = g
    for fn in ("coalesce", "to_undirected"):
        assert_same(getattr(graph, fn)(ei, w, n),
                    getattr(jx_graph, fn)(ei, w, n), fn)
        assert_same(getattr(graph, fn)(ei), getattr(jx_graph, fn)(ei), fn)


@pytest.mark.parametrize("fill", [1.0, 0.5, 2.0])
def test_add_remaining_self_loops(g, fill):
    ei, w, n = g
    w = w.astype(np.float64)
    assert_same(graph.add_remaining_self_loops(ei, w, n, fill),
                jx_graph.add_remaining_self_loops(ei, w, n, fill))


@pytest.mark.parametrize("improved,loops", [(False, True), (True, True),
                                            (False, False)])
def test_gcn_norm(g, improved, loops):
    ei, w, n = g
    assert_same(graph.gcn_norm(ei, w, n, improved, loops),
                jx_graph.gcn_norm(ei, w, n, improved, loops))


def test_directed_features_in_out(g):
    ei, w, n = g
    got = graph.directed_features_in_out(ei, n, w)
    assert_same(got, jx_graph.directed_features_in_out(ei, n, w))
    assert_same(graph.directed_features_in_out(ei, n),
                jx_graph.directed_features_in_out(ei, n))
    assert got[1].shape[1] > ei.shape[1]


def jx_coo_arrays(A):
    return (np.asarray(A.row)[:A.nnz].astype(np.int64),
            np.asarray(A.col)[:A.nnz].astype(np.int64),
            np.asarray(A.val)[:A.nnz])


def port_coo_arrays(A):
    return A.row.numpy(), A.col.numpy(), A.val.numpy()


def single_builders(ei, w, n):
    """(name, port builder, JAX builder) of every single-operator
    builder, each as ``f(mode, **kw)``."""
    rev = ei[[1, 0]]
    return {
        "gcn_norm": (lambda m, **kw: graph.gcn_norm_propagator(
                         ei, w, n, mode=m, **kw),
                     lambda m: jx_graph.gcn_norm_propagator(ei, w, n,
                                                            mode=m)),
        "gcn_norm improved": (
            lambda m, **kw: graph.gcn_norm_propagator(
                ei, w, n, improved=True, mode=m, **kw),
            lambda m: jx_graph.gcn_norm_propagator(ei, w, n, improved=True,
                                                   mode=m)),
        "norm source_to_target": (
            lambda m, **kw: graph.norm_propagator(ei, w, n, mode=m, **kw),
            lambda m: jx_graph.norm_propagator(ei, w, n, mode=m)),
        "norm target_to_source": (
            lambda m, **kw: graph.norm_propagator(
                rev, w, n, flow="target_to_source", mode=m, **kw),
            lambda m: jx_graph.norm_propagator(
                rev, w, n, flow="target_to_source", mode=m)),
        "rw_norm": (lambda m, **kw: graph.rw_norm_propagator(
                        ei, w, n, mode=m, **kw),
                    lambda m: jx_graph.rw_norm_propagator(ei, w, n, mode=m)),
        "rw_norm fill 0, no loops": (
            lambda m, **kw: graph.rw_norm_propagator(
                ei, w, n, fill_value=0.0, add_self_loops=False, mode=m,
                **kw),
            lambda m: jx_graph.rw_norm_propagator(
                ei, w, n, fill_value=0.0, add_self_loops=False, mode=m)),
    }


def dual_builders(ei, w, n):
    return {
        "rw_norm_dual": (
            lambda m, **kw: graph.rw_norm_dual_propagator(ei, w, n, mode=m,
                                                          **kw),
            lambda m: jx_graph.rw_norm_dual_propagator(ei, w, n, mode=m)),
        "adj_dual": (
            lambda m, **kw: graph.adj_dual_propagator(ei, w, n, mode=m,
                                                      **kw),
            lambda m: jx_graph.adj_dual_propagator(ei, w, n, mode=m)),
    }


@pytest.mark.parametrize("name", sorted(single_builders(*messy_graph())))
def test_single_propagators_hold_the_jax_arrays(g, name):
    ei, w, n = g
    mine, theirs = single_builders(ei, w, n)[name]
    P, J = mine("segment", device="cpu"), theirs("segment")
    assert P.mode == J.mode == "segment"
    assert_same(port_coo_arrays(P.coo), jx_coo_arrays(J.coo), name)
    D, JD = mine("dense", device="cpu"), theirs("dense")
    assert_same(D.dense.numpy(), np.asarray(JD.dense), name)


@pytest.mark.parametrize("name", sorted(dual_builders(*messy_graph())))
def test_dual_propagators_hold_the_jax_arrays(g, name):
    ei, w, n = g
    mine, theirs = dual_builders(ei, w, n)[name]
    d, j = mine("segment", device="cpu"), theirs("segment")
    for a, b in ((d, j), (d.transposed, j.transposed)):
        nnz = a.col.numel()
        assert_same((a.row.numpy(), a.col.numpy(), a.val_a.numpy(),
                     a.val_b.numpy()),
                    (np.asarray(b.row)[:nnz].astype(np.int64),
                     np.asarray(b.col)[:nnz].astype(np.int64),
                     np.asarray(b.val_a)[:nnz],
                     np.asarray(b.val_b)[:nnz]), name)
    assert mine("dense", device="cpu") is None
    assert theirs("dense") is None


# --- applies against a dense reference ---------------------------------------

def dense_reference(row, col, val, n):
    A = np.zeros((n, n))
    np.add.at(A, (row, col), np.asarray(val, np.float64))
    return A


def single_reference(name, ei, w, n):
    """The float64 dense operator each builder freezes, from its
    definition."""
    w = np.asarray(w, np.float64)
    if name.startswith("gcn_norm"):
        e2, norm = jx_graph.gcn_norm(ei, w, n, improved="improved" in name)
        return dense_reference(e2[1], e2[0], norm, n)
    if name == "norm source_to_target":
        return dense_reference(ei[1], ei[0], w, n)
    if name == "norm target_to_source":
        return dense_reference(ei[1], ei[0], w, n)    # rev[0], rev[1]
    fill = 0.0 if "fill 0" in name else 0.5
    e2, w2 = ((ei, w) if "no loops" in name else
              jx_graph.add_remaining_self_loops(ei, w, n, fill))
    A = dense_reference(e2[0], e2[1], w2, n)
    deg = A.sum(1)
    return np.divide(A, deg[:, None], out=np.zeros_like(A),
                     where=deg[:, None] > 0)


@pytest.fixture
def knobs(monkeypatch):
    """``knobs(**values)`` sets the same layout knobs on both packages."""
    def set_(**values):
        for k, v in values.items():
            monkeypatch.setattr(layout, k, v)
            monkeypatch.setattr(scatter_mxu, k, v)
    return set_


STREAM = dict(STREAM_THRESHOLD_EDGES=100, STREAM_BLOCK_EDGES=128)


@pytest.mark.parametrize("width", [3, 5, 32])
@pytest.mark.parametrize("tier", TIERS + ["mxu streamed"])
@pytest.mark.parametrize("name", sorted(single_builders(*messy_graph())))
def test_single_applies_match_the_dense_reference(name, tier, width, knobs):
    ei, w, n = messy_graph(seed=2)
    if tier == "mxu streamed":
        knobs(**STREAM)
    mode = tier.split()[0]
    mine, theirs = single_builders(ei, w, n)[name]
    P, J = mine(mode, device="cpu"), theirs(mode)
    if tier == "mxu streamed":
        assert P.csr.streamed and P.csr.transposed.streamed
        assert J.mxu.stream is not None
    A = single_reference(name, ei, w, n)
    rng = np.random.default_rng(width)
    x = rng.standard_normal((n, width)).astype(np.float32)
    g = rng.standard_normal((n, width)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = P(xt)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), A @ x, **F32_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), A.T @ g, **F32_TOL)
    xj = jnp.asarray(x)
    np.testing.assert_allclose(np.asarray(J(xj)), A @ x, **F32_TOL)
    np.testing.assert_allclose(
        np.asarray(jax.grad(lambda v: jnp.sum(J(v) * g))(xj)), A.T @ g,
        **F32_TOL)


def dual_reference(name, ei, w, n):
    """(A, B) of each fused builder, float64 dense, from its definition."""
    if name == "adj_dual":
        A = dense_reference(ei[0], ei[1], w, n)
        return A, A.T
    fwd = single_reference("rw_norm", ei, w, n)
    return fwd, single_reference("rw_norm", ei[[1, 0]], w, n)


@pytest.mark.parametrize("fa", [5, 32])
@pytest.mark.parametrize("tier", ["segment", "mxu", "mxu streamed"])
@pytest.mark.parametrize("name", sorted(dual_builders(*messy_graph())))
def test_dual_applies_match_the_dense_reference(name, tier, fa, knobs):
    ei, w, n = messy_graph(seed=3)
    if tier == "mxu streamed":
        knobs(**STREAM)
    mine, theirs = dual_builders(ei, w, n)[name]
    mode = tier.split()[0]
    D, J = mine(mode, device="cpu"), theirs(mode)
    if tier == "mxu streamed":
        assert D.streamed and D.transposed.streamed
        assert J.stream is not None
    A, B = dual_reference(name, ei, w, n)
    rng = np.random.default_rng(fa)
    x = rng.standard_normal((n, 2 * fa)).astype(np.float32)
    g = rng.standard_normal((n, 2 * fa)).astype(np.float32)
    want = np.concatenate([A @ x[:, :fa], B @ x[:, fa:]], 1)
    want_g = np.concatenate([A.T @ g[:, :fa], B.T @ g[:, fa:]], 1)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = spmm.dual_spmm_stacked(D, xt)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, **F32_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, **F32_TOL)
    xj = jnp.asarray(x)
    np.testing.assert_allclose(np.asarray(jx_spmm.dual_spmm_stacked(J, xj)),
                               want, **F32_TOL)
    np.testing.assert_allclose(
        np.asarray(jax.grad(
            lambda v: jnp.sum(jx_spmm.dual_spmm_stacked(J, v) * g))(xj)),
        want_g, **F32_TOL)


# --- spectral/appr.py ---------------------------------------------------------

def test_fast_appr_power(g):
    ei, w, n = g
    import scipy.sparse as sp

    A = sp.csr_matrix((w, (ei[0], ei[1])), shape=(n, n))
    for kw in ({}, dict(alpha=0.2, personalize=np.arange(n) + 1.0)):
        L, pi = appr.fast_appr_power(A, **kw)
        JL, jpi = jx_appr.fast_appr_power(A, **kw)
        assert_same((L.indptr, L.indices, L.data, pi),
                    (JL.indptr, JL.indices, JL.data, jpi))


@pytest.mark.parametrize("fn", ["cal_fast_appr", "appr_directed_adj"])
def test_ppr_adjacencies(g, fn):
    ei, w, n = g
    for args in ((ei, n, w), (ei, None)):
        got = getattr(appr, fn)(0.1, *args)
        assert_same(got, getattr(jx_appr, fn)(0.1, *args), fn)
        assert got[0].dtype == np.int64 and got[1].dtype == np.float32


def test_second_directed_adj(g):
    ei, w, n = g
    for args in ((ei, n, w), (ei, None)):
        assert_same(appr.second_directed_adj(*args),
                    jx_appr.second_directed_adj(*args))
