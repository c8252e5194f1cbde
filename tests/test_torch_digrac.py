"""DIGRAC in the port vs the JAX package: the probabilistic imbalance loss
in its dense, pair and fused dual forms for every normalization and
threshold (values and gradients); DIMPA and DIGRAC_node_clustering,
forward and every gradient with the weights carried over, in the pair
and fused forms on each tier; the Hermitian features; and the numpy
standard scaler and adjusted Rand index against scikit-learn's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg  # noqa: F401
import torch
from sklearn.metrics import adjusted_rand_score as sk_ari
from sklearn.preprocessing import StandardScaler

from pytorch_geometric_signed_directed_tpu import graph as jx_graph
from pytorch_geometric_signed_directed_tpu.data import DSBM as jx_DSBM
from pytorch_geometric_signed_directed_tpu.nn import (
    DIGRAC_node_clustering as JxDIGRAC, DIMPA as JxDIMPA)
from pytorch_geometric_signed_directed_tpu.spectral import (
    features as jx_features)
from pytorch_geometric_signed_directed_tpu.utils import (
    Prob_Imbalance_Loss as JxLoss,
    meta_graph_generation as jx_meta_graph_generation)

from pytorch_geometric_signed_directed_tpu_torch import graph
from pytorch_geometric_signed_directed_tpu_torch.convert import (
    state_dict_from_jax)
from pytorch_geometric_signed_directed_tpu_torch.data import DirectedData
from pytorch_geometric_signed_directed_tpu_torch.nn import (
    DIGRAC_node_clustering, DIMPA)
from pytorch_geometric_signed_directed_tpu_torch.spectral import features
from pytorch_geometric_signed_directed_tpu_torch.utils import (
    Prob_Imbalance_Loss, adjusted_rand_score)

from test_torch_worker_memory import release_memory  # noqa: F401

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
# the model tolerance of tests/test_torch_msgnn.py: sums in other orders
# through two MLPs, hops and a softmax
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
NORMS = ["vol_sum", "vol_min", "vol_max", "plain"]
THRESHOLDS = ["sort", "std", "naive"]


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def dsbm(n=90, k=3, p=0.3, seed=0, style="cyclic"):
    F = jx_meta_graph_generation(style, k, 0.05, False)
    A, y = jx_DSBM(n, k, p, F, rng=np.random.default_rng(seed))
    A = A.tocoo()
    ei = np.vstack([A.row, A.col]).astype(np.int64)
    return ei, A.data.astype(np.float32), y, F


def probabilities(y, k, sharp, seed):
    """[N, K] cluster probabilities: the planted clusters (``sharp``
    large, so strongly imbalanced flows pass the 'std' threshold) or
    near-uniform noise (``sharp`` 0, so none passes)."""
    rng = np.random.default_rng(seed)
    logits = sharp * np.eye(k)[y] + 0.3 * rng.standard_normal((len(y), k))
    e = np.exp(logits - logits.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


def adjacency_args(form, ei, w, n):
    """(port A, JAX A) of one form of the loss's adjacency argument."""
    if form == "dense":
        A = np.zeros((n, n), np.float32)
        np.add.at(A, (ei[0], ei[1]), w)
        return torch.from_numpy(A), A
    if form == "pair":
        rev = ei[[1, 0]]
        return ((graph.norm_propagator(rev, w, n, mode="mxu", device="cpu"),
                 graph.norm_propagator(ei, w, n, mode="mxu", device="cpu")),
                (jx_graph.norm_propagator(rev, w, n, mode="mxu"),
                 jx_graph.norm_propagator(ei, w, n, mode="mxu")))
    return (graph.adj_dual_propagator(ei, w, n, device="cpu"),
            jx_graph.adj_dual_propagator(ei, w, n))


@pytest.mark.parametrize("threshold", THRESHOLDS)
@pytest.mark.parametrize("normalization", NORMS)
@pytest.mark.parametrize("form", ["dense", "pair", "dual"])
def test_imbalance_loss_value_and_gradient(form, normalization, threshold):
    ei, w, y, F = dsbm()
    n, k = len(y), 3
    A, JA = adjacency_args(form, ei, w, n)
    for sharp, sel in ((6.0, F), (0.0, 2)):
        P = probabilities(y, k, sharp, seed=int(sharp))
        jloss = JxLoss(sel)
        jval, jgrad = jax.value_and_grad(
            lambda p: jloss(p, JA, k, normalization, threshold))(
                jnp.asarray(P))
        Pt = t(P).requires_grad_(True)
        val = Prob_Imbalance_Loss(sel)(Pt, A, k, normalization, threshold)
        val.backward()
        assert val.shape == ()
        np.testing.assert_allclose(val.item(), float(jval), **LOSS_TOL)
        np.testing.assert_allclose(Pt.grad.numpy(), np.asarray(jgrad),
                                   **LOSS_TOL)


def test_std_threshold_cases_are_both_reached():
    """The planted probabilities pass the 'std' test for some pair, the
    noise passes it for none (so both branches above are exercised)."""
    ei, w, y, _ = dsbm()
    A = np.zeros((len(y), len(y)))
    np.add.at(A, (ei[0], ei[1]), w)
    for sharp, passes in ((6.0, True), (0.0, False)):
        P = probabilities(y, 3, sharp, seed=int(sharp)).astype(np.float64)
        W = P.T @ A @ P
        iu, ju = np.triu_indices(3, 1)
        stat = (W[iu, ju] - W[ju, iu]) ** 2 - 9 * (W[iu, ju] + W[ju, iu])
        assert (stat > 0).any() == passes


@pytest.mark.parametrize("style,k", [("cyclic", 3), ("path", 4),
                                     ("complete", 5), ("cyclic", 2)])
def test_sel_from_an_int_or_a_meta_graph(style, k):
    F = jx_meta_graph_generation(style, k, 0.1, False)
    assert Prob_Imbalance_Loss(F).sel == JxLoss(F).sel
    assert Prob_Imbalance_Loss(k).sel == JxLoss(k).sel == k
    assert Prob_Imbalance_Loss().sel is JxLoss().sel is None
    # only a Python int counts as one: a numpy integer falls through to
    # F.shape in both packages
    for cls in (Prob_Imbalance_Loss, JxLoss):
        with pytest.raises(IndexError):
            cls(np.int64(k))


# --- DIMPA and DIGRAC ---------------------------------------------------------

def operators(ei, w, n, mode, fused):
    """(port P_s, P_t, A), (JAX P_s, P_t, A)."""
    if fused:
        return ((graph.rw_norm_dual_propagator(ei, w, n, mode=mode,
                                               device="cpu"), None,
                 graph.adj_dual_propagator(ei, w, n, mode=mode,
                                           device="cpu")),
                (jx_graph.rw_norm_dual_propagator(ei, w, n, mode=mode), None,
                 jx_graph.adj_dual_propagator(ei, w, n, mode=mode)))
    rev = ei[[1, 0]]

    def build(g):
        kw = {} if g is jx_graph else dict(device="cpu")
        return (g.rw_norm_propagator(ei, w, n, mode=mode, **kw),
                g.rw_norm_propagator(rev, w, n, mode=mode, **kw),
                (g.norm_propagator(rev, w, n, mode=mode, **kw),
                 g.norm_propagator(ei, w, n, mode=mode, **kw)))

    return build(graph), build(jx_graph)


FORMS = [("dense", False), ("segment", False), ("mxu", False),
         ("segment", True), ("mxu", True)]


def assert_grads_match(module, jax_grads, tol=MODEL_TOL):
    want = state_dict_from_jax(jax.device_get(jax_grads))
    got = {k: p.grad for k, p in module.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **tol)


@pytest.mark.parametrize("mode,fused", FORMS)
def test_dimpa_forward_and_grads(mode, fused):
    ei, w, y, _ = dsbm(n=70, seed=4)
    n, f, hop = len(y), 6, 3
    (P_s, P_t, _), (J_s, J_t, _) = operators(ei, w, n, mode, fused)
    rng = np.random.default_rng(1)
    x_s, x_t = (rng.standard_normal((n, f)).astype(np.float32)
                for _ in range(2))
    g = rng.standard_normal((n, 2 * f)).astype(np.float32)
    jm = JxDIMPA(hop)
    params = jm.init(jax.random.PRNGKey(0), x_s, x_t, J_s, J_t)
    params = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.uniform(-0.5, 0.5, a.shape),
                                  jnp.float32), params)

    def jloss(p, a, b):
        out = jm.apply(p, a, b, J_s, J_t)
        return jnp.sum(out * g), out

    (_, want), (jg, jga, jgb) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(params, x_s, x_t)
    m = DIMPA(hop, device="cpu")
    m.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    a, b = t(x_s).requires_grad_(True), t(x_t).requires_grad_(True)
    out = m(a, b, P_s, P_t)
    (out * t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **MODEL_TOL)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(jga), **MODEL_TOL)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(jgb), **MODEL_TOL)
    assert_grads_match(m, jg)


@pytest.mark.parametrize("mode,fused", FORMS)
def test_digrac_forward_and_grads(mode, fused):
    ei, w, y, F = dsbm(n=80, k=3, seed=5)
    n, k = len(y), 3
    (P_s, P_t, A), (J_s, J_t, JA) = operators(ei, w, n, mode, fused)
    rng = np.random.default_rng(2)
    x = rng.random((n, 4)).astype(np.float32)
    gz = rng.standard_normal((n, 32)).astype(np.float32)
    gl = rng.standard_normal((n, k)).astype(np.float32)
    jm = JxDIGRAC(num_features=4, hidden=16, nclass=k, hop=2)
    params = jm.init(jax.random.PRNGKey(3), J_s, J_t, x)
    jimb = JxLoss(F)

    def jloss(p):
        z, logp, pred, prob = jm.apply(p, J_s, J_t, x)
        loss = (jimb(prob, JA, k) + jnp.sum(z * gz) + jnp.sum(logp * gl))
        return loss, (z, logp, pred, prob)

    (jl, want), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    m = DIGRAC_node_clustering(num_features=4, hidden=16, nclass=k, hop=2,
                               device="cpu")
    m.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    z, logp, pred, prob = m(P_s, P_t, t(x))
    loss = (Prob_Imbalance_Loss(F)(prob, A, k) + (z * t(gz)).sum()
            + (logp * t(gl)).sum())
    loss.backward()
    for a, b in ((z, want[0]), (logp, want[1]), (prob, want[3])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   **MODEL_TOL)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(loss.item(), float(jl), **MODEL_TOL)
    assert_grads_match(m, jg)


def test_digrac_weights_come_from_the_generator():
    def make(seed):
        return DIGRAC_node_clustering(
            5, 8, 3, device="cpu",
            generator=torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = make(0), make(0), make(1)
    assert set(a) == {"w_s0.weight", "w_s1.weight", "w_t0.weight",
                      "w_t1.weight", "dimpa._w_s", "dimpa._w_t", "W_prob",
                      "bias"}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["W_prob"], c["W_prob"])
    # xavier-uniform with gain 1.414: |w| < sqrt(12 / (fan_in + fan_out))
    assert a["W_prob"].abs().max() < np.sqrt(12 / (16 + 3))
    assert a["w_s0.weight"].abs().max() < np.sqrt(12 / (5 + 8))
    assert torch.equal(a["bias"], torch.zeros(3))


def test_digrac_dropout_acts_only_when_training():
    ei, w, y, _ = dsbm(n=60, seed=6)
    n = len(y)
    P_s = graph.rw_norm_propagator(ei, w, n, device="cpu")
    P_t = graph.rw_norm_propagator(ei[[1, 0]], w, n, device="cpu")
    m = DIGRAC_node_clustering(3, 8, 3, dropout=0.5, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    x = torch.rand(n, 3)
    assert m.training            # a fresh Module, and still no dropout
    a, b = m(P_s, P_t, x)[0], m(P_s, P_t, x)[0]
    assert torch.equal(a, b)
    gen = torch.Generator().manual_seed(1)
    c = m(P_s, P_t, x, True, gen)[0]
    d = m(P_s, P_t, x, True, torch.Generator().manual_seed(1))[0]
    assert torch.equal(c, d) and not torch.equal(a, c)


# --- Hermitian features -------------------------------------------------------

@pytest.fixture
def fixed_svds(monkeypatch):
    """``svds`` with a fixed start vector, recording each matrix it is
    given: both packages then compute the same vectors."""
    seen = []
    svds = sp.linalg.svds

    def fixed(M, k=6, **kw):
        seen.append(M)
        v0 = np.random.default_rng(0).standard_normal(min(M.shape))
        return svds(M, k=k, v0=v0.astype(M.dtype), **kw)

    monkeypatch.setattr(sp.linalg, "svds", fixed)
    return seen


@pytest.mark.parametrize("n,k", [(120, 2), (200, 3)])
def test_hermitian_features_match_jax(fixed_svds, n, k):
    ei, w, y, _ = dsbm(n=n, k=k, p=0.2, seed=k)
    A = sp.csr_matrix((w, (ei[0], ei[1])), shape=(n, n))
    got = features.hermitian_features(A, k)
    want = jx_features.hermitian_features(A, k)
    H, JH = fixed_svds
    assert H.dtype == JH.dtype and H.shape == JH.shape
    for a, b in ((H.indptr, JH.indptr), (H.indices, JH.indices),
                 (H.data, JH.data)):
        np.testing.assert_array_equal(a, b)
    assert got.dtype == want.dtype == np.float32 and got.shape == (n, 2 * k)
    np.testing.assert_array_equal(got, want)
    # the setter of DirectedData
    data = DirectedData(A=A.tocoo(), y=y)
    data.set_hermitian_features(k)
    np.testing.assert_array_equal(data.x, want)


def test_hermitian_spectrum_is_that_of_a_direct_svds(monkeypatch):
    """Unpatched, the start vector is random, so compare what it cannot
    change: the singular values and the projector U U^H.  (Two leading
    singular values well apart from the third, 0.59 against 0.35, and
    float64 weights: the projector is then defined to rounding.)"""
    ei, w, _, _ = dsbm(n=150, k=3, p=0.2, seed=7)
    A = sp.csr_matrix((w.astype(np.float64), (ei[0], ei[1])),
                      shape=(150, 150))
    svds = sp.linalg.svds
    got = {}

    def spy(M, k=6, **kw):
        got["H"] = M
        u, s, vh = svds(M, k=k, **kw)
        got["u"], got["s"] = u, s
        return u, s, vh

    monkeypatch.setattr(sp.linalg, "svds", spy)
    features.hermitian_features(A, 2)
    monkeypatch.setattr(sp.linalg, "svds", svds)
    u, s, _ = svds(got["H"], k=2)
    np.testing.assert_allclose(np.sort(got["s"]), np.sort(s), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got["u"] @ got["u"].conj().T,
                               u @ u.conj().T, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_standard_scale_is_sklearns(seed, dtype):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.standard_normal((200, 3)) * [1, 1e-3, 50] + 7,
                        np.full((200, 1), 3.3), np.zeros((200, 1))],
                       1).astype(dtype)
    got = features.standard_scale(X)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, StandardScaler().fit(X).transform(X))


# --- the adjusted Rand index --------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_ari_matches_sklearn_on_random_labelings(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 400))
    a = rng.integers(0, int(rng.integers(1, 8)), n)
    b = np.where(rng.random(n) < 0.7, a, rng.integers(0, 6, n)) + 3
    assert adjusted_rand_score(a, b) == sk_ari(a, b)


@pytest.mark.parametrize("a,b", [
    ([0, 0, 0, 0], [1, 1, 1, 1]),        # one cluster each
    ([0, 1, 2, 3], [3, 2, 1, 0]),        # every point alone in both
    ([0, 0, 0, 0], [0, 1, 2, 3]),        # one cluster against singletons
    ([0, 0, 1, 1], [0, 1, 0, 1]),
    ([0, 0, 1, 2], [0, 0, 1, 1]),
    ([5], [2]), ([], [])])
def test_ari_special_cases(a, b):
    assert adjusted_rand_score(a, b) == sk_ari(a, b)
