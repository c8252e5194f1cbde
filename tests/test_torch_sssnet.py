"""SIMPA, SSSNET, SGCNConv and SGCN in the port vs the JAX package, with
the same weights carried over by ``state_dict_from_jax``: every output
and every gradient (inputs and parameters) on the dense, segment and
kernel ("mxu") tiers of the operators the models use (the signed walk
operators, the mean operators and their fused union-edge-set dual).  The
JAX kernel tier runs its Pallas kernels in interpret mode on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_signed_directed_tpu import graph as jx_graph
from pytorch_geometric_signed_directed_tpu.data import ssbm as jx_ssbm
from pytorch_geometric_signed_directed_tpu.nn import (
    SGCN as JxSGCN, SGCNConv as JxSGCNConv, SIMPA as JxSIMPA,
    SSSNET_link_prediction as JxSSSNETLink,
    SSSNET_node_clustering as JxSSSNETNode)
from pytorch_geometric_signed_directed_tpu.nn.signed import sgcn as jx_sgcn
from pytorch_geometric_signed_directed_tpu.utils import (
    negative_sampling as jx_negative_sampling,
    structured_negative_sampling as jx_structured)
from pytorch_geometric_signed_directed_tpu.utils.signed import (
    balanced_loss as jx_balanced)

from pytorch_geometric_signed_directed_tpu_torch import graph
from pytorch_geometric_signed_directed_tpu_torch.convert import (
    state_dict_from_jax)
from pytorch_geometric_signed_directed_tpu_torch.nn import (
    SGCN, SGCNConv, SIMPA, SSSNET_link_prediction, SSSNET_node_clustering)
from pytorch_geometric_signed_directed_tpu_torch.nn.signed import sgcn
from pytorch_geometric_signed_directed_tpu_torch.utils import (
    Prob_Balanced_Normalized_Loss, negative_sampling,
    structured_negative_sampling)

from test_torch_worker_memory import release_memory  # noqa: F401

# the tolerance of tests/test_torch_msgnn.py: sums in other orders through
# MLPs, hops and a softmax
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
TIERS = ["dense", "segment", "mxu"]


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def signed_walks(mode, n=120, seed=0, directed=False):
    """A symmetric SSBM's positive and negative edges, as (port, JAX)
    walk operators: P_p with a self-loop fill of 0.5, P_n with none (and
    the transposed pair when ``directed``, on a graph with one direction
    of each pair dropped)."""
    (A_p, A_n), y = jx_ssbm.SSBM(n, 3, 0.15, 0.1, size_ratio=1.5,
                                 rng=np.random.default_rng(seed))
    sides = []
    for A, fill in ((A_p, 0.5), (A_n, 0.0)):
        A = A.tocoo()
        ei, w = np.vstack([A.row, A.col]).astype(np.int64), A.data
        if directed:
            keep = ei[0] < ei[1]
            ei, w = ei[:, keep], w[keep]
        sides.append((ei, w, fill))
    ops = [[], []]
    for rev in ((False, True) if directed else (False,)):
        for ei, w, fill in sides:
            e = ei[[1, 0]] if rev else ei
            ops[0].append(graph.rw_norm_propagator(e, w, n, fill, mode=mode,
                                                   device="cpu"))
            ops[1].append(jx_graph.rw_norm_propagator(e, w, n, fill,
                                                      mode=mode))
    return ops[0], ops[1], y, (A_p, A_n)


def perturbed(params, rng):
    """Weights moved off their initial values (SIMPA's hop weights start
    at 1, the biases at 0)."""
    return jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.uniform(-0.5, 0.5, a.shape),
                                  jnp.float32), params)


def assert_grads_match(module, jax_grads, tol=MODEL_TOL):
    want = state_dict_from_jax(jax.device_get(jax_grads))
    got = {k: p.grad for k, p in module.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **tol)


def load(module, params):
    module.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    return module


# --- SIMPA -------------------------------------------------------------------

@pytest.mark.parametrize("hop", [1, 2, 3])
@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("mode", TIERS)
def test_simpa_forward_and_grads(mode, directed, hop):
    ops, jops, _, _ = signed_walks(mode, directed=directed)
    n, f = ops[0].num_nodes, 5
    rng = np.random.default_rng(hop)
    xs = [rng.standard_normal((n, f)).astype(np.float32)
          for _ in range(4 if directed else 2)]
    g = rng.standard_normal((n, (4 if directed else 2) * f)).astype(
        np.float32)

    def jargs(ops_, xs_):
        if not directed:
            return (ops_[0], ops_[1], *xs_)
        return (ops_[0], ops_[1], xs_[0], xs_[1], ops_[2], ops_[3], xs_[2],
                xs_[3])

    jm = JxSIMPA(hop, directed)
    params = perturbed(jm.init(jax.random.PRNGKey(0), *jargs(jops, xs)), rng)

    def jloss(p, *jx):
        out = jm.apply(p, *jargs(jops, jx))
        return jnp.sum(out * g), out

    (_, want), grads = jax.value_and_grad(
        jloss, argnums=tuple(range(len(xs) + 1)), has_aux=True)(params, *xs)
    m = load(SIMPA(hop, directed, device="cpu"), params)
    xt = [t(x).requires_grad_(True) for x in xs]
    out = m(*jargs(ops, xt))
    (out * t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **MODEL_TOL)
    for x, gx in zip(xt, grads[1:]):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx),
                                   **MODEL_TOL)
    assert_grads_match(m, grads[0])


def test_simpa_skips_the_dead_walk():
    """At hop 2 a forward applies P_p four times and P_n twice (the JAX
    text's fifth P_p feeds nothing; XLA drops it, and so does the port)."""
    counts = {"p": 0, "n": 0}

    def counting(key):
        def apply(x):
            counts[key] += 1
            return x
        return apply

    x = torch.ones(4, 2)
    SIMPA(2, device="cpu")(counting("p"), counting("n"), x, x)
    assert counts == {"p": 4, "n": 2}


# --- SSSNET --------------------------------------------------------------------

@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("mode", TIERS)
def test_sssnet_node_clustering_forward_and_grads(mode, directed):
    ops, jops, y, (A_p, A_n) = signed_walks(mode, seed=1, directed=directed)
    n, k = ops[0].num_nodes, 3
    rng = np.random.default_rng(2)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    gz = rng.standard_normal((n, (4 if directed else 2) * 8)).astype(
        np.float32)
    gl = rng.standard_normal((n, k)).astype(np.float32)
    extra = (jops[2], jops[3]) if directed else ()
    jm = JxSSSNETNode(nfeat=4, hidden=8, nclass=k, hop=2, directed=directed)
    params = perturbed(jm.init(jax.random.PRNGKey(3), jops[0], jops[1], x,
                               *extra), rng)
    jcut = jx_balanced.Prob_Balanced_Normalized_Loss(A_p.tocsr(),
                                                     A_n.tocsr(), mode=mode)

    def jloss(p):
        z, logp, pred, prob = jm.apply(p, jops[0], jops[1], x, *extra)
        return (jcut(prob) + jnp.sum(z * gz) + jnp.sum(logp * gl),
                (z, logp, pred, prob))

    (jl, want), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    m = load(SSSNET_node_clustering(nfeat=4, hidden=8, nclass=k, hop=2,
                                    directed=directed, device="cpu"), params)
    cut = Prob_Balanced_Normalized_Loss(A_p.tocsr(), A_n.tocsr(), mode=mode,
                                        device="cpu")
    z, logp, pred, prob = m(ops[0], ops[1], t(x), *ops[2:])
    loss = cut(prob) + (z * t(gz)).sum() + (logp * t(gl)).sum()
    loss.backward()
    for a, b in ((z, want[0]), (logp, want[1]), (prob, want[3])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   **MODEL_TOL)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(loss.item(), float(jl), **MODEL_TOL)
    assert_grads_match(m, jg)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("mode", ["segment", "mxu"])
def test_sssnet_link_prediction_forward_and_grads(mode, directed, bias):
    ops, jops, _, _ = signed_walks(mode, seed=2, directed=directed)
    n = ops[0].num_nodes
    rng = np.random.default_rng(4)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    q = rng.integers(0, n, (50, 2))
    g = rng.standard_normal((50, 2)).astype(np.float32)
    extra = (jops[2], jops[3]) if directed else ()
    jm = JxSSSNETLink(nfeat=3, hidden=6, nclass=2, hop=2, directed=directed,
                      bias=bias)
    params = perturbed(jm.init(jax.random.PRNGKey(5), jops[0], jops[1], x, q,
                               *extra), rng)

    def jloss(p):
        out = jm.apply(p, jops[0], jops[1], x, q, *extra)
        return jnp.sum(out * g), out

    (_, want), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    m = load(SSSNET_link_prediction(nfeat=3, hidden=6, nclass=2, hop=2,
                                    directed=directed, bias=bias,
                                    device="cpu"), params)
    out = m(ops[0], ops[1], t(x), torch.as_tensor(q), *ops[2:])
    (out * t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **MODEL_TOL)
    assert_grads_match(m, jg)


def test_sssnet_weights_come_from_the_generator():
    a = SSSNET_node_clustering(5, 8, 3, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    b = SSSNET_node_clustering(5, 8, 3, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    for (k, p), (_, q) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(p, q), k
    sd = a.state_dict()
    assert set(sd) == {"trunk.w_p0.weight", "trunk.w_p1.weight",
                       "trunk.w_n0.weight", "trunk.w_n1.weight",
                       "trunk.simpa._w_p", "trunk.simpa._w_n", "W_prob",
                       "bias"}
    # xavier-uniform with gain 1.414
    assert sd["W_prob"].abs().max() <= np.sqrt(12 / (16 + 3))
    assert torch.equal(sd["trunk.simpa._w_n"], torch.ones(3, 1))


def test_sssnet_dropout_acts_only_when_training():
    ops, _, _, _ = signed_walks("segment", seed=3)
    n = ops[0].num_nodes
    m = SSSNET_node_clustering(3, 8, 3, dropout=0.5, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    x = torch.rand(n, 3)
    assert m.training            # a fresh Module, and still no dropout
    a, b = m(ops[0], ops[1], x)[0], m(ops[0], ops[1], x)[0]
    assert torch.equal(a, b)
    c = m(ops[0], ops[1], x, training=True,
          generator=torch.Generator().manual_seed(1))[0]
    d = m(ops[0], ops[1], x, training=True,
          generator=torch.Generator().manual_seed(1))[0]
    assert torch.equal(c, d) and not torch.equal(a, c)


# --- SGCNConv and SGCN -----------------------------------------------------------

def signed_edge_list(n=90, m=600, seed=0):
    """[M, 3] uniform draws with duplicates and self-loops, as bench.py's
    ``_signed_edge_array``."""
    rng = np.random.default_rng(seed)
    return np.column_stack([rng.integers(0, n, m), rng.integers(0, n, m),
                            np.where(rng.random(m) < 0.75, 1, -1)]), n


FORMS = [("dense", False), ("segment", False), ("mxu", False),
         ("segment", True), ("mxu", True)]


def sgcn_operators(mode, fused, n, es, x):
    got = sgcn.prepare_sgcn_inputs(n, es, in_dim=x.shape[1], init_emb=x,
                                   mode=mode, fused=fused, device="cpu")
    want = jx_sgcn.prepare_sgcn_inputs(n, es, in_dim=x.shape[1],
                                       init_emb=x, mode=mode, fused=fused)
    if fused:
        assert got[4] is None and want[4] is None
    return got, want


@pytest.mark.parametrize("norm_emb", [False, True])
@pytest.mark.parametrize("first_aggr", [True, False])
@pytest.mark.parametrize("mode,fused", FORMS)
def test_sgcn_conv_forward_and_grads(mode, fused, first_aggr, norm_emb):
    es, n = signed_edge_list(seed=1)
    rng = np.random.default_rng(6)
    f, out_dim = 6, 5
    width = f if first_aggr else 2 * f
    x = rng.standard_normal((n, width)).astype(np.float32)
    g = rng.standard_normal((n, 2 * out_dim)).astype(np.float32)
    got, want = sgcn_operators(mode, fused, n, es, x)
    jm = JxSGCNConv(f, out_dim, first_aggr=first_aggr, norm_emb=norm_emb)
    params = perturbed(jm.init(jax.random.PRNGKey(7), x, want[3], want[4]),
                       rng)

    def jloss(p, xx):
        out = jm.apply(p, xx, want[3], want[4])
        return jnp.sum(out * g), out

    (_, jout), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, x)
    m = load(SGCNConv(f, out_dim, first_aggr, norm_emb=norm_emb,
                      device="cpu"), params)
    xt = t(x).requires_grad_(True)
    out = m(xt, got[3], got[4])
    (out * t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **MODEL_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **MODEL_TOL)
    assert_grads_match(m, jg)


def samples(pos, neg, n, seed, jax_side):
    """The non-edges and the two triplet sets, drawn by one package's
    samplers from one generator (the same draws in both)."""
    rng = np.random.default_rng(seed)
    if jax_side:
        ns, ss = jx_negative_sampling, jx_structured
    else:
        ns, ss = negative_sampling, structured_negative_sampling
    none = ns(np.concatenate([pos, neg], 1), n, rng=rng)
    return none, ss(pos, n, rng=rng), ss(neg, n, rng=rng)


@pytest.mark.parametrize("init_emb_grad", [False, True])
@pytest.mark.parametrize("layer_num,norm_emb", [(2, False), (3, True)])
@pytest.mark.parametrize("mode,fused", FORMS)
def test_sgcn_loss_and_grads(mode, fused, layer_num, norm_emb,
                             init_emb_grad):
    es, n = signed_edge_list(seed=2)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    got, want = sgcn_operators(mode, fused, n, es, x)
    pos, neg = got[0], got[1]
    jsamp = samples(pos, neg, n, 9, jax_side=True)
    psamp = samples(pos, neg, n, 9, jax_side=False)
    for a, b in zip((jsamp[0], *jsamp[1], *jsamp[2]),
                    (psamp[0], *psamp[1], *psamp[2])):
        np.testing.assert_array_equal(a, b)
    kw = dict(node_num=n, in_dim=8, out_dim=6, layer_num=layer_num,
              lamb=5.0, norm_emb=norm_emb, init_emb_grad=init_emb_grad)
    jm = JxSGCN(init_emb=x, **kw)
    args = (want[3], want[4], pos, neg, *jsamp)
    params = perturbed(jm.init(jax.random.PRNGKey(10), *args,
                               method=JxSGCN.loss), rng)
    jl, jg = jax.value_and_grad(
        lambda p: jm.apply(p, *args, method=JxSGCN.loss))(params)
    jz = jm.apply(params, want[3], want[4])
    m = load(SGCN(init_emb=x, device="cpu", **kw), params)
    z = m(got[3], got[4])
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz),
                               **MODEL_TOL)
    loss = m.loss(got[3], got[4], pos, neg, *psamp)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **MODEL_TOL)
    assert_grads_match(m, jg)
    assert ("x" in dict(m.named_parameters())) == init_emb_grad
    assert "x" not in m.state_dict() or init_emb_grad


def test_sgcn_needs_an_embedding():
    with pytest.raises(ValueError, match="init_emb"):
        SGCN(10, device="cpu")


def test_sgcn_trains_a_copy_of_the_embedding():
    emb = np.ones((3, 4), np.float32)
    m = SGCN(3, in_dim=4, out_dim=4, init_emb=emb, init_emb_grad=True,
             device="cpu")
    with torch.no_grad():
        m.x.add_(1.0)
    np.testing.assert_array_equal(emb, np.ones((3, 4), np.float32))
