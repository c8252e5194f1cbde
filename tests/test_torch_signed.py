"""The signed family's host code and losses in the port vs the JAX
package: the SSBM and polarized SSBM generators, ``extract_network``, the
signed spectral features (``eigs`` given a fixed start vector), SGCN's
spectral embedding (the numpy randomized SVD against scikit-learn's), the
triplet sampler, the SGCN edge split and operators (bit-equal arrays),
and the balanced-cut and link-sign losses (values and gradients) on the
dense, segment and kernel tiers, one case streamed with lowered knobs.
The JAX kernel tier runs its Pallas kernels in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg  # noqa: F401
import torch
from sklearn.decomposition import TruncatedSVD

from pytorch_geometric_signed_directed_tpu import graph as jx_graph
from pytorch_geometric_signed_directed_tpu.data import (
    SignedData as JxSignedData)
from pytorch_geometric_signed_directed_tpu.data import (
    polarized_ssbm as jx_polarized, ssbm as jx_ssbm)
from pytorch_geometric_signed_directed_tpu.nn.signed import sgcn as jx_sgcn
from pytorch_geometric_signed_directed_tpu.ops import coo as jx_coo
from pytorch_geometric_signed_directed_tpu.ops.pallas import scatter_mxu
from pytorch_geometric_signed_directed_tpu.spectral import (
    features as jx_features)
from pytorch_geometric_signed_directed_tpu.utils import (
    extract_network as jx_extract_network)
from pytorch_geometric_signed_directed_tpu.utils.general import (
    triplet_loss as jx_triplet)
from pytorch_geometric_signed_directed_tpu.utils.signed import (
    balanced_loss as jx_balanced, link_sign_loss as jx_lsl)

from pytorch_geometric_signed_directed_tpu_torch import graph
from pytorch_geometric_signed_directed_tpu_torch.convert import (
    state_dict_from_jax)
from pytorch_geometric_signed_directed_tpu_torch.data import (
    SSBM, SignedData, polarized_SSBM, ssbm)
from pytorch_geometric_signed_directed_tpu_torch.nn.signed import sgcn
from pytorch_geometric_signed_directed_tpu_torch.ops import (
    coalesce, coo_from_scipy, layout)
from pytorch_geometric_signed_directed_tpu_torch.spectral import features
from pytorch_geometric_signed_directed_tpu_torch.utils import (
    Prob_Balanced_Normalized_Loss, Prob_Balanced_Ratio_Loss, Unhappy_Ratio,
    extract_network)
from pytorch_geometric_signed_directed_tpu_torch.utils.general import (
    triplet_loss)
from pytorch_geometric_signed_directed_tpu_torch.utils.signed import (
    link_sign_loss as lsl)

from test_torch_worker_memory import release_memory  # noqa: F401

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
FEATURE_TOL = dict(rtol=1e-6, atol=1e-6)
TIERS = ["dense", "segment", "mxu", "mxu streamed"]
STREAM = dict(STREAM_THRESHOLD_EDGES=300, STREAM_BLOCK_EDGES=256)


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def assert_same_sparse(a, b, what=""):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    a.sort_indices()
    b.sort_indices()
    assert a.shape == b.shape and a.dtype == b.dtype, what
    for x, y in ((a.indptr, b.indptr), (a.indices, b.indices),
                 (a.data, b.data)):
        np.testing.assert_array_equal(x, y, err_msg=what)


def signed_graph(n=200, k=3, seed=0, p=0.1):
    """A JAX SSBM cut to its largest component, as a JAX SignedData with
    A_p and A_n separated."""
    (A_p, A_n), y = jx_ssbm.SSBM(n, k, p, 0.1, size_ratio=1.5,
                                 rng=np.random.default_rng(seed))
    A, y = jx_extract_network((A_p - A_n).tocsr(), y)
    data = JxSignedData(A=A, y=y)
    data.separate_positive_negative()
    return data


# --- generators -------------------------------------------------------------

@pytest.mark.parametrize("n,k,p,eta,size_ratio,values", [
    (300, 3, 0.1, 0.1, 1.5, "ones"), (200, 4, 0.2, 0.05, 2.0, "exp"),
    (150, 2, 0.3, 0.2, 1.0, "uniform"), (90, 5, 0.15, 0.1, 1.0, "ones")])
def test_ssbm_is_bit_equal(n, k, p, eta, size_ratio, values):
    (a, b), y = SSBM(n, k, p, eta, size_ratio=size_ratio, values=values,
                     rng=np.random.default_rng(n))
    (ja, jb), jy = jx_ssbm.SSBM(n, k, p, eta, size_ratio=size_ratio,
                                values=values, rng=np.random.default_rng(n))
    assert_same_sparse(a, ja, "A_p")
    assert_same_sparse(b, jb, "A_n")
    np.testing.assert_array_equal(y, jy)
    assert a.nnz and b.nnz and (abs(a - a.T)).nnz == 0


def test_ssbm_with_other_between_probabilities():
    kw = dict(pout=0.02, etaout=0.3, size_ratio=1.2)
    (a, b), y = SSBM(120, 3, 0.3, 0.1, rng=np.random.default_rng(2), **kw)
    (ja, jb), jy = jx_ssbm.SSBM(120, 3, 0.3, 0.1,
                                rng=np.random.default_rng(2), **kw)
    assert_same_sparse(a, ja)
    assert_same_sparse(b, jb)
    np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 50])
def test_upper_pairs_decode_triu_indices(n):
    iu, iv = np.triu_indices(n, k=1)
    r, c = ssbm._upper_pairs(np.arange(len(iu)), n)
    np.testing.assert_array_equal(r, iu)
    np.testing.assert_array_equal(c, iv)


@pytest.mark.parametrize("values", ["ones", "exp", "uniform"])
def test_fill_draws_as_jax(values):
    np.testing.assert_array_equal(
        ssbm.fill(values, 9, np.random.default_rng(4)),
        jx_ssbm.fill(values, 9, np.random.default_rng(4)))


@pytest.mark.parametrize("kw", [
    dict(total_n=300, num_com=2, N=50, K=2, p=0.1),
    dict(total_n=200, num_com=3, N=30, K=3, p=0.15, eta=0.2,
         size_ratio=1.5)])
def test_polarized_ssbm_is_bit_equal(kw):
    (a, b), y, g = polarized_SSBM(rng=np.random.default_rng(3), **kw)
    (ja, jb), jy, jg = jx_polarized.polarized_SSBM(
        rng=np.random.default_rng(3), **kw)
    assert_same_sparse(a, ja)
    assert_same_sparse(b, jb)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(g, jg)


@pytest.mark.parametrize("lowest_degree", [1, 2, 3, 40])
def test_extract_network_is_bit_equal(lowest_degree):
    # sparse enough to fall apart into components
    (a, b), y = jx_ssbm.SSBM(250, 3, 0.01, 0.1, size_ratio=1.5,
                             rng=np.random.default_rng(5))
    A = (a - b).tocsr()
    got, gy = extract_network(A, y, lowest_degree)
    want, wy = jx_extract_network(A, y, lowest_degree)
    assert_same_sparse(got, want)
    np.testing.assert_array_equal(gy, wy)
    assert got.shape[0] < 250
    got, none = extract_network(A, None, lowest_degree)
    assert none is None
    assert_same_sparse(got, want)


# --- spectral features --------------------------------------------------------

@pytest.fixture
def fixed_eigs(monkeypatch):
    """``eigs`` with a fixed start vector: both packages then compute the
    same vectors."""
    eigs = sp.linalg.eigs

    def fixed(M, k=6, **kw):
        v0 = np.random.default_rng(0).standard_normal(M.shape[0])
        return eigs(M, k=k, v0=v0, **kw)

    monkeypatch.setattr(sp.linalg, "eigs", fixed)


@pytest.mark.parametrize("normalization", [None, "sym", "sym_sep"])
@pytest.mark.parametrize("k,seed", [(3, 0), (2, 1)])
def test_spectral_adjacency_reg_features(fixed_eigs, normalization, k, seed):
    data = signed_graph(seed=seed, k=k)
    got = features.spectral_adjacency_reg_features(data.A_p, data.A_n, k,
                                                   normalization)
    want = jx_features.spectral_adjacency_reg_features(data.A_p, data.A_n,
                                                       k, normalization)
    assert got.dtype == np.float32 and got.shape == (data.num_nodes, k)
    np.testing.assert_allclose(got, want, **FEATURE_TOL)


@pytest.mark.parametrize("normalization", [None, "sym", "sym_sep"])
def test_reg_features_with_given_taus_and_eigens(fixed_eigs, normalization):
    data = signed_graph(seed=2)
    kw = dict(tau_p=0.01, tau_n=0.03, eigens=4, mi=500)
    got = features.spectral_adjacency_reg_features(
        data.A_p, data.A_n, 3, normalization, **kw)
    want = jx_features.spectral_adjacency_reg_features(
        data.A_p, data.A_n, 3, normalization, **kw)
    assert got.shape == (data.num_nodes, 4)
    np.testing.assert_allclose(got, want, **FEATURE_TOL)


def test_reg_features_reject_an_unknown_normalization():
    data = signed_graph()
    with pytest.raises(NameError):
        features.spectral_adjacency_reg_features(data.A_p, data.A_n, 2,
                                                 "rw")


def test_reg_operator_is_its_definition():
    """The matrix-free operators against the regularized matrix built
    densely from the definition (tau on every entry)."""
    data = signed_graph(n=120, seed=3)
    A_p = data.A_p.toarray().astype(np.float64)
    A_n = data.A_n.toarray().astype(np.float64)
    n = len(A_p)
    seen = {}
    eigs = sp.linalg.eigs

    def spy(M, k=6, **kw):
        seen["op"] = M
        return eigs(M, k=k, **kw)

    tp, tn = 0.02, 0.005
    ones = np.ones((n, n))
    deg_p, deg_n = A_p.sum(0), A_n.sum(0)
    D_sym = (((A_p != 0) * (A_p + tp)).sum(0) + ((A_n != 0) * (A_n + tn))
             .sum(0) + (n - deg_p - deg_n) * abs(tp - tn)) ** -0.5
    dp, dn = (deg_p + n * tp) ** -0.5, (deg_n + n * tn) ** -0.5
    want = {
        None: A_p - A_n + (tp - tn) * ones,
        "sym": D_sym[:, None] * (A_p - A_n + (tp - tn) * ones) * D_sym,
        "sym_sep": (dp[:, None] * (A_p + tp * ones) * dp
                    - dn[:, None] * (A_n + tn * ones) * dn)}
    v = np.random.default_rng(0).standard_normal((n, 3))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sp.linalg, "eigs", spy)
        for norm, M in want.items():
            features.spectral_adjacency_reg_features(
                data.A_p, data.A_n, 2, norm, tau_p=tp, tau_n=tn)
            got = np.stack([seen["op"].matvec(v[:, i]) for i in range(3)], 1)
            np.testing.assert_allclose(got, M @ v, rtol=1e-5, atol=1e-6,
                                       err_msg=str(norm))


@pytest.mark.parametrize("k", [2, 3])
def test_signed_laplacian_features(fixed_eigs, k):
    data = signed_graph(seed=k)
    got = features.signed_laplacian_eig_features(data.A_p, data.A_n, k)
    want = jx_features.signed_laplacian_eig_features(data.A_p, data.A_n, k)
    assert got.dtype == np.float32 and got.shape == (data.num_nodes, k)
    np.testing.assert_allclose(got, want, **FEATURE_TOL)


def test_signed_data_feature_setters(fixed_eigs):
    jdata = signed_graph(seed=4)
    data = SignedData(A=jdata.A, y=jdata.y)
    for name, kw in (("set_signed_Laplacian_features", dict(k=2)),
                     ("set_spectral_adjacency_reg_features",
                      dict(k=3, normalization="sym"))):
        getattr(data, name)(**kw)
        getattr(jdata, name)(**kw)
        np.testing.assert_allclose(data.x, jdata.x, **FEATURE_TOL)
        assert not hasattr(data, "A_p")


def test_reg_features_unpatched_share_the_spectrum(monkeypatch):
    """With its own random start vector each call finds the same
    eigenvalues, and (the two leading ones apart from the third) the same
    span."""
    data = signed_graph(n=200, k=3, seed=6, p=0.15)
    got = {}
    eigs = sp.linalg.eigs

    def spy(M, k=6, **kw):
        got["op"] = M
        w, v = eigs(M, k=k, **kw)
        got["w"], got["v"] = w, v
        return w, v

    monkeypatch.setattr(sp.linalg, "eigs", spy)
    features.spectral_adjacency_reg_features(data.A_p, data.A_n, 2, "sym")
    monkeypatch.setattr(sp.linalg, "eigs", eigs)
    w, v = eigs(got["op"], k=3, which="LR")
    w, v = w[np.argsort(-w.real)], v[:, np.argsort(-w.real)]
    assert w[1].real - w[2].real > 0.05
    np.testing.assert_allclose(np.sort(got["w"].real), np.sort(w[:2].real),
                               rtol=1e-6, atol=1e-6)
    Q = np.linalg.qr(np.real(got["v"]))[0]
    R = np.linalg.qr(np.real(v[:, :2]))[0]
    np.testing.assert_allclose(Q @ Q.T, R @ R.T, atol=1e-6)


# --- SGCN's spectral embedding ------------------------------------------------

def signed_edges(n=150, e_pos=600, e_neg=200, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, (2, e_pos)), rng.integers(0, n, (2, e_neg)),
            n)


@pytest.mark.parametrize("seed,dim", [(0, 8), (3, 4), (7, 16)])
def test_create_spectral_features_is_bit_equal(seed, dim):
    pos, neg, n = signed_edges(seed=seed)
    got = features.create_spectral_features(pos, neg, n, dim, seed=seed)
    want = jx_features.create_spectral_features(pos, neg, n, dim, seed=seed)
    assert got.dtype == np.float32 and got.shape == (n, dim)
    np.testing.assert_array_equal(got, want)


def test_create_spectral_features_with_numpys_global_state():
    pos, neg, n = signed_edges(seed=1)
    np.random.seed(5)
    got = features.create_spectral_features(pos, neg, n, 8)
    np.random.seed(5)
    want = jx_features.create_spectral_features(pos, neg, n, 8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_randomized_svd_is_truncated_svds(dtype):
    rng = np.random.default_rng(2)
    M = sp.random(90, 70, density=0.1, random_state=3, format="csr",
                  dtype=dtype)
    M.data = rng.standard_normal(M.nnz).astype(dtype)
    got = features.randomized_svd_components(M, 5, random_state=11)
    svd = TruncatedSVD(n_components=5, n_iter=128, random_state=11).fit(M)
    assert got.dtype == svd.components_.dtype
    np.testing.assert_array_equal(got, svd.components_)


@pytest.mark.parametrize("seed", range(3))
def test_sorted_unique_with_inverse(seed):
    keys = np.random.default_rng(seed).integers(0, 40, 300)
    u, inv = coalesce.sorted_unique(keys, return_inverse=True)
    ju, jinv = np.unique(keys, return_inverse=True)
    np.testing.assert_array_equal(u, ju)
    np.testing.assert_array_equal(inv, jinv)
    np.testing.assert_array_equal(coalesce.sorted_unique(keys), ju)


# --- samplers, edge split and SGCN operators ----------------------------------

@pytest.mark.parametrize("n_sample,k", [(200, 3), (50, 4), (1000, 2)])
def test_triplet_sampler_draws_as_jax(n_sample, k):
    y = np.random.default_rng(k).integers(0, k, 130)
    got = triplet_loss.sample_triplets(y, 130, n_sample,
                                       np.random.default_rng(1))
    want = jx_triplet.sample_triplets(y, 130, n_sample,
                                      np.random.default_rng(1))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("thre", [0.1, 0.0, 5.0])
def test_triplet_loss_value_and_gradient(thre):
    rng = np.random.default_rng(0)
    y = rng.integers(0, 3, 100)
    Z = rng.standard_normal((100, 6)).astype(np.float32)
    trip = jx_triplet.sample_triplets(y, 100, 200, np.random.default_rng(2))
    jval, jgrad = jax.value_and_grad(
        lambda z: jx_triplet.triplet_loss_inner_product(z, *trip, thre=thre)
    )(jnp.asarray(Z))
    Zt = t(Z).requires_grad_(True)
    val = triplet_loss.triplet_loss_inner_product(Zt, *trip, thre=thre)
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), **LOSS_TOL)
    np.testing.assert_allclose(Zt.grad.numpy(), np.asarray(jgrad),
                               **LOSS_TOL)
    # the whole function draws from the generator as JAX's does
    got = triplet_loss.triplet_loss_node_classification(
        y, t(Z), 200, thre, np.random.default_rng(3))
    want = jx_triplet.triplet_loss_node_classification(
        y, jnp.asarray(Z), 200, thre, np.random.default_rng(3))
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)


def signed_edge_list(n=90, m=500, seed=0):
    """[M, 3] with duplicates and self-loops, as bench.py draws them."""
    rng = np.random.default_rng(seed)
    return np.column_stack([rng.integers(0, n, m), rng.integers(0, n, m),
                            np.where(rng.random(m) < 0.7, 1, -1)]), n


def test_split_signed_edges_is_bit_equal():
    es, _ = signed_edge_list()
    got, want = sgcn.split_signed_edges(es), jx_sgcn.split_signed_edges(es)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def jx_arrays(A):
    nnz = A.nnz
    return (np.asarray(A.row)[:nnz].astype(np.int64),
            np.asarray(A.col)[:nnz].astype(np.int64),
            np.asarray(A.val)[:nnz])


@pytest.mark.parametrize("flow", ["source_to_target", "target_to_source"])
def test_mean_propagator_holds_the_jax_arrays(flow):
    es, n = signed_edge_list(seed=1)
    pos, _ = sgcn.split_signed_edges(es)
    P = graph.mean_propagator(pos, n, flow=flow, mode="segment",
                              device="cpu")
    J = jx_graph.mean_propagator(pos, n, flow=flow, mode="segment")
    for a, b in zip((P.coo.row, P.coo.col, P.coo.val), jx_arrays(J.coo)):
        np.testing.assert_array_equal(a.numpy(), b)
    # duplicates stay separate entries
    assert P.coo.nnz == pos.shape[1]
    dense = graph.mean_propagator(pos, n, flow=flow, mode="dense",
                                  device="cpu")
    np.testing.assert_array_equal(
        dense.dense.numpy(),
        np.asarray(jx_graph.mean_propagator(pos, n, flow=flow,
                                            mode="dense").dense))


def test_sgcn_dual_propagator_holds_the_jax_arrays():
    es, n = signed_edge_list(seed=2)
    pos, neg = sgcn.split_signed_edges(es)
    d = sgcn.sgcn_dual_propagator(pos, neg, n, mode="segment", device="cpu")
    j = jx_sgcn.sgcn_dual_propagator(pos, neg, n, mode="segment")
    for a, b in ((d, j), (d.transposed, j.transposed)):
        nnz = a.col.numel()
        assert nnz == pos.shape[1] + neg.shape[1]
        for x, y in ((a.row, b.row), (a.col, b.col)):
            np.testing.assert_array_equal(x.numpy(),
                                          np.asarray(y)[:nnz].astype(np.int64))
        for x, y in ((a.val_a, b.val_a), (a.val_b, b.val_b)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y)[:nnz])
    assert sgcn.sgcn_dual_propagator(pos, neg, n, mode="dense",
                                     device="cpu") is None


@pytest.mark.parametrize("mode", ["segment", "mxu", "mxu streamed"])
def test_sgcn_operators_apply_as_jax(mode, monkeypatch):
    """Pair and fused operators on each tier: [P_pos x | P_neg x]."""
    if mode == "mxu streamed":
        for k, v in STREAM.items():
            monkeypatch.setattr(layout, k, v)
            monkeypatch.setattr(scatter_mxu, k, v)
        mode = "mxu"
    es, n = signed_edge_list(seed=3)
    x = np.random.default_rng(0).standard_normal((n, 6)).astype(np.float32)
    for fused in (False, True):
        got = sgcn.prepare_sgcn_inputs(n, es, in_dim=6, init_emb=x,
                                       mode=mode, fused=fused, device="cpu")
        want = jx_sgcn.prepare_sgcn_inputs(n, es, in_dim=6, init_emb=x,
                                           mode=mode, fused=fused)
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
        if fused:
            from pytorch_geometric_signed_directed_tpu.ops.spmm import (
                dual_spmm_stacked as jx_dual)
            from pytorch_geometric_signed_directed_tpu_torch.ops import (
                dual_spmm_stacked)
            assert got[4] is None and want[4] is None
            xx = np.concatenate([x, x], 1)
            out = dual_spmm_stacked(got[3], t(xx)).numpy()
            ref = np.asarray(jx_dual(want[3], jnp.asarray(xx)))
        else:
            out = np.concatenate([got[3](t(x)).numpy(), got[4](t(x)).numpy()],
                                 1)
            ref = np.concatenate([np.asarray(want[3](jnp.asarray(x))),
                                  np.asarray(want[4](jnp.asarray(x)))], 1)
        np.testing.assert_allclose(out, ref, **LOSS_TOL)


def test_prepare_sgcn_inputs_builds_the_spectral_embedding():
    es, n = signed_edge_list(seed=4)
    got = sgcn.prepare_sgcn_inputs(n, es, in_dim=8, mode="segment",
                                   device="cpu")
    pos, neg = sgcn.split_signed_edges(es)
    np.random.seed(0)
    a = features.create_spectral_features(pos, neg, n, 8)
    np.random.seed(0)
    b = jx_features.create_spectral_features(pos, neg, n, 8)
    np.testing.assert_array_equal(a, b)
    assert got[2].shape == (n, 8) and got[2].dtype == np.float32


def test_coo_from_scipy_holds_the_jax_arrays():
    M = sp.random(40, 30, density=0.2, random_state=1, format="csc")
    got = coo_from_scipy(M, device="cpu")
    want = jx_coo.coo_from_scipy(M)
    assert got.shape == want.shape == (40, 30)
    for a, b in zip((got.row, got.col, got.val), jx_arrays(want)):
        np.testing.assert_array_equal(a.numpy(), b)


# --- balanced-cut losses --------------------------------------------------------

BALANCED = {"normalized": (Prob_Balanced_Normalized_Loss,
                           jx_balanced.Prob_Balanced_Normalized_Loss),
            "ratio": (Prob_Balanced_Ratio_Loss,
                      jx_balanced.Prob_Balanced_Ratio_Loss),
            "unhappy": (Unhappy_Ratio, jx_balanced.Unhappy_Ratio)}


def probabilities(n, k, seed):
    logits = 2.0 * np.random.default_rng(seed).standard_normal((n, k))
    e = np.exp(logits - logits.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("name", sorted(BALANCED))
def test_balanced_loss_value_and_gradient(name, tier, monkeypatch):
    data = signed_graph(n=180, seed=7)
    mode = tier.split()[0]
    if tier == "mxu streamed":
        for k, v in STREAM.items():
            monkeypatch.setattr(layout, k, v)
            monkeypatch.setattr(scatter_mxu, k, v)
    A_p, A_n = data.A_p.tocsr(), data.A_n.tocsr()
    mine, theirs = BALANCED[name]
    loss = mine(A_p, A_n, mode=mode, device="cpu")
    jloss = theirs(A_p, A_n, mode=mode)
    assert loss.mat.mode == mode
    if tier == "mxu streamed":
        assert loss.mat.csr.streamed and loss.mat.csr.transposed.streamed
    P = probabilities(data.num_nodes, 3, seed=1)
    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(P))
    Pt = t(P).requires_grad_(True)
    val = loss(Pt)
    val.backward()
    assert val.shape == ()
    np.testing.assert_allclose(val.item(), float(jval), **LOSS_TOL)
    np.testing.assert_allclose(Pt.grad.numpy(), np.asarray(jgrad),
                               **LOSS_TOL)


def test_balanced_operators_are_their_definition():
    """mat = D_p - (A_p - A_n) and D_bar = D_p + D_n, the degrees row
    sums, against a dense build (the diagonal D_bar: one entry a row)."""
    data = signed_graph(n=150, seed=8)
    A_p, A_n = data.A_p.toarray(), data.A_n.toarray()
    loss = Prob_Balanced_Normalized_Loss(data.A_p, data.A_n, mode="segment",
                                         device="cpu")
    D_p, D_n = np.diag(A_p.sum(1)), np.diag(A_n.sum(1))
    np.testing.assert_allclose(loss.mat.coo.to_dense().numpy(),
                               D_p - (A_p - A_n), rtol=1e-6)
    np.testing.assert_allclose(loss.D_bar.coo.to_dense().numpy(), D_p + D_n,
                               rtol=1e-6)
    assert loss.D_bar.coo.nnz == int(((D_p + D_n) != 0).sum())
    un = Unhappy_Ratio(data.A_p, data.A_n, device="cpu")
    assert un.num_edges == jx_balanced.Unhappy_Ratio(
        data.A_p, data.A_n).num_edges == data.edge_index.shape[1]


# --- link-sign losses -----------------------------------------------------------

def embedding_and_edges(n=80, dim=6, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, dim)).astype(np.float32)
    pos, neg, none = (rng.integers(0, n, (2, m)) for m in (120, 40, 60))
    return z, pos, neg, none, rng


def carried(module, params):
    module.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    return module


def check_module_loss(mine, jmod, z, *args):
    """A flax loss and the port's, from the same weights: value and the
    gradients with respect to z and every weight."""
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(z), *args)
    (jval, (jgz, jgp)) = jax.value_and_grad(
        lambda zz, p: jmod.apply(p, zz, *args), argnums=(0, 1))(
            jnp.asarray(z), params)
    m = carried(mine, params)
    zt = t(z).requires_grad_(True)
    val = m(zt, *[torch.as_tensor(np.asarray(a)) for a in args])
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), **LOSS_TOL)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(jgz), **LOSS_TOL)
    want = state_dict_from_jax(jax.device_get(jgp))
    got = {k: p.grad for k, p in m.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **LOSS_TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_link_sign_entropy_loss(seed):
    z, pos, neg, none, _ = embedding_and_edges(seed=seed)
    check_module_loss(lsl.Link_Sign_Entropy_Loss(6, device="cpu"),
                      jx_lsl.Link_Sign_Entropy_Loss(6), z, pos, neg, none)


def test_sign_triangle_loss():
    z, pos, neg, _, rng = embedding_and_edges(seed=2)
    w_pos = rng.uniform(0, 3, pos.shape[1]).astype(np.float32)
    w_neg = rng.uniform(0, 3, neg.shape[1]).astype(np.float32)
    check_module_loss(lsl.Sign_Triangle_Loss(6, device="cpu"),
                      jx_lsl.Sign_Triangle_Loss(6), z, pos, neg, w_pos, w_neg)


@pytest.mark.parametrize("scale", [0.3, 3.0])
def test_sign_direction_loss(scale):
    z, pos, neg, _, _ = embedding_and_edges(seed=3)
    check_module_loss(lsl.Sign_Direction_Loss(6, device="cpu"),
                      jx_lsl.Sign_Direction_Loss(6), z * scale, pos, neg)


@pytest.mark.parametrize("name", ["sign_product_entropy_loss",
                                  "link_sign_product_loss"])
def test_product_losses(name):
    z, pos, neg, _, _ = embedding_and_edges(seed=4)
    z = 0.5 * z
    jval, jg = jax.value_and_grad(getattr(jx_lsl, name))(
        jnp.asarray(z), pos, neg)
    zt = t(z).requires_grad_(True)
    val = getattr(lsl, name)(zt, torch.as_tensor(pos), torch.as_tensor(neg))
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), **LOSS_TOL)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(jg), **LOSS_TOL)
    cls = {"sign_product_entropy_loss": lsl.Sign_Product_Entropy_Loss,
           "link_sign_product_loss": lsl.Link_Sign_Product_Loss}[name]
    np.testing.assert_allclose(cls()(t(z), pos, neg).item(), float(jval),
                               **LOSS_TOL)


def test_sign_structure_loss_with_sampled_triplets():
    from pytorch_geometric_signed_directed_tpu_torch.utils import (
        structured_negative_sampling)

    z, pos, neg, _, _ = embedding_and_edges(seed=5)
    n = z.shape[0]
    ps = structured_negative_sampling(pos, n, np.random.default_rng(1))
    ns = structured_negative_sampling(neg, n, np.random.default_rng(2))
    # a tie (j == k makes the hinge's argument 0) gets half the gradient
    # in both packages
    ps[2][:3] = ps[1][:3]
    jval, jg = jax.value_and_grad(jx_lsl.sign_structure_loss)(
        jnp.asarray(z), ps, ns)
    zt = t(z).requires_grad_(True)
    val = lsl.sign_structure_loss(zt, [torch.as_tensor(a) for a in ps],
                                  [torch.as_tensor(a) for a in ns])
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), **LOSS_TOL)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(jg), **LOSS_TOL)
    np.testing.assert_allclose(lsl.Sign_Structure_Loss()(t(z), ps, ns).item(),
                               float(jval), **LOSS_TOL)


@pytest.mark.parametrize("seed", range(3))
def test_sampler_membership_is_isin(seed):
    """The samplers' sorted-search membership test against ``np.isin``,
    with repeated keys and keys past either end of the table."""
    from pytorch_geometric_signed_directed_tpu_torch.utils.signed import (
        sampling)

    rng = np.random.default_rng(seed)
    table = coalesce.sorted_unique(rng.integers(10, 200, 80))
    keys = rng.integers(0, 220, 500)
    np.testing.assert_array_equal(sampling._member(keys, table),
                                  np.isin(keys, table))
    assert not sampling._member(keys, table[:0]).any()
    assert sampling._member(keys[:0], table).shape == (0,)
