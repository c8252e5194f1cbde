"""DiGCN, its inception blocks and DGCN in the port vs the JAX package,
with the same weights carried over by ``state_dict_from_jax``: every
output and every parameter gradient, on the dense, segment and kernel
("mxu") tiers of the operators the experiments build (the PPR and
second-order adjacencies; the symmetrized, in and out graphs).  The JAX
kernel tier runs its Pallas kernels in interpret mode on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_signed_directed_tpu import graph as jx_graph
from pytorch_geometric_signed_directed_tpu.data import DSBM as jx_DSBM
from pytorch_geometric_signed_directed_tpu.experiments import (
    dgcn_node as jx_dgcn_node)
from pytorch_geometric_signed_directed_tpu.nn import (
    DGCN_link_prediction as JxDGCNLink,
    DGCN_node_classification as JxDGCNNode,
    DiGCN_Inception_Block as JxBlock,
    DiGCN_Inception_Block_link_prediction as JxInceptionLink,
    DiGCN_Inception_Block_node_classification as JxInceptionNode,
    DiGCN_link_prediction as JxDiGCNLink,
    DiGCN_node_classification as JxDiGCNNode,
    DiGCNConv as JxDiGCNConv)
from pytorch_geometric_signed_directed_tpu.spectral import (
    appr_directed_adj as jx_appr_directed_adj,
    second_directed_adj as jx_second_directed_adj)
from pytorch_geometric_signed_directed_tpu.utils import (
    meta_graph_generation as jx_meta_graph_generation)

from pytorch_geometric_signed_directed_tpu_torch import graph
from pytorch_geometric_signed_directed_tpu_torch.convert import (
    state_dict_from_jax)
from pytorch_geometric_signed_directed_tpu_torch.data import DirectedData
from pytorch_geometric_signed_directed_tpu_torch.experiments import dgcn_node
from pytorch_geometric_signed_directed_tpu_torch.nn import (
    DGCN_link_prediction, DGCN_node_classification, DiGCN_Inception_Block,
    DiGCN_Inception_Block_link_prediction,
    DiGCN_Inception_Block_node_classification, DiGCN_link_prediction,
    DiGCN_node_classification, DiGCNConv)
from pytorch_geometric_signed_directed_tpu_torch.spectral import (
    appr_directed_adj, second_directed_adj)

from test_torch_worker_memory import release_memory  # noqa: F401

# the tolerance of tests/test_torch_msgnn.py
TOL = dict(rtol=2e-4, atol=2e-4)
TIERS = ["dense", "segment", "mxu"]
N = 120


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def digraph(n=N, seed=0):
    F = jx_meta_graph_generation("path", 3, 0.05, False)
    A, y = jx_DSBM(n, 3, 0.15, F, rng=np.random.default_rng(seed))
    A = A.tocoo()
    return np.vstack([A.row, A.col]).astype(np.int64), A.data, y


def digcn_ops(mode, n=N):
    """The PPR and second-order adjacencies as (port, JAX) Propagators."""
    ei, w, _ = digraph(n)
    e1, w1 = appr_directed_adj(0.1, ei, n, w)
    e2, w2 = second_directed_adj(ei, n, w)
    je1, jw1 = jx_appr_directed_adj(0.1, ei, n, w)
    je2, jw2 = jx_second_directed_adj(ei, n, w)
    return ((graph.norm_propagator(e1, w1, n, mode=mode, device="cpu"),
             graph.norm_propagator(e2, w2, n, mode=mode, device="cpu")),
            (jx_graph.norm_propagator(je1, jw1, n, mode=mode),
             jx_graph.norm_propagator(je2, jw2, n, mode=mode)))


def dgcn_ops(mode, n=N):
    """The symmetrized, in and out graphs, GCN-normalized."""
    ei, w, _ = digraph(n, seed=1)
    arrays = graph.directed_features_in_out(ei, n, w)
    jarrays = jx_graph.directed_features_in_out(ei, n, w)
    pairs = ((arrays[0], None), (arrays[1], arrays[2]),
             (arrays[3], arrays[4]))
    jpairs = ((jarrays[0], None), (jarrays[1], jarrays[2]),
              (jarrays[3], jarrays[4]))
    return (tuple(graph.gcn_norm_propagator(e, v, n, mode=mode, device="cpu")
                  for e, v in pairs),
            tuple(jx_graph.gcn_norm_propagator(e, v, n, mode=mode)
                  for e, v in jpairs))


def assert_grads_match(module, jax_grads):
    want = state_dict_from_jax(jax.device_get(jax_grads))
    got = {k: p.grad for k, p in module.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **TOL)


def check(jmodel, model, jargs, args, out_width, seed, query=None):
    """Forward and every gradient of ``model`` against ``jmodel`` from
    the same weights, on ``sum(out * g)`` plus the NLL of random labels
    (so the log-softmax's gradient is not zero)."""
    rng = np.random.default_rng(seed)
    rows = N if query is None else len(query)
    g = rng.standard_normal((rows, out_width)).astype(np.float32)
    y = rng.integers(0, out_width, rows)
    extra = () if query is None else (query,)
    params = jmodel.init(jax.random.PRNGKey(seed), *jargs, *extra)

    def jloss(p):
        out = jmodel.apply(p, *jargs, *extra)
        return jnp.sum(out * g) - jnp.mean(out[jnp.arange(rows), y]), out

    (jl, want), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    model.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    extra_t = () if query is None else (torch.from_numpy(query),)
    out = model(*args, *extra_t)
    loss = (out * t(g)).sum() - out[torch.arange(rows),
                                    torch.from_numpy(y)].mean()
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    assert_grads_match(model, jg)


def features(f=2, seed=0):
    return np.random.default_rng(seed).random((N, f)).astype(np.float32)


def queries(seed=0, q=150):
    return np.random.default_rng(seed).integers(0, N, (q, 2)).astype(
        np.int64)


@pytest.mark.parametrize("mode", TIERS)
@pytest.mark.parametrize("out_ch,bias", [(5, True), (16, False)])
def test_digcn_conv(mode, out_ch, bias):
    (P, _), (J, _) = digcn_ops(mode)
    x = features(4, seed=out_ch)
    check(JxDiGCNConv(out_ch, use_bias=bias),
          DiGCNConv(4, out_ch, bias, device="cpu"), (x, J), (t(x), P),
          out_ch, seed=out_ch)


@pytest.mark.parametrize("mode", TIERS)
def test_digcn_node_classification(mode):
    (P, _), (J, _) = digcn_ops(mode)
    x = features()
    check(JxDiGCNNode(num_features=2, hidden=16, label_dim=3),
          DiGCN_node_classification(2, 16, 3, device="cpu"), (x, J),
          (t(x), P), 3, seed=1)


@pytest.mark.parametrize("mode", TIERS)
def test_digcn_link_prediction(mode):
    (P, _), (J, _) = digcn_ops(mode)
    x, q = features(), queries()
    check(JxDiGCNLink(num_features=2, hidden=16, label_dim=2),
          DiGCN_link_prediction(2, 16, 2, device="cpu"), (x, J), (t(x), P),
          2, seed=2, query=q)


@pytest.mark.parametrize("mode", TIERS)
def test_inception_block(mode):
    (P1, P2), (J1, J2) = digcn_ops(mode)
    x = features(3, seed=3)
    rng = np.random.default_rng(3)
    gs = [rng.standard_normal((N, 8)).astype(np.float32) for _ in range(3)]
    jb = JxBlock(8)
    params = jb.init(jax.random.PRNGKey(3), x, J1, J2)

    def jloss(p):
        outs = jb.apply(p, x, J1, J2)
        return sum(jnp.sum(o * g) for o, g in zip(outs, gs)), outs

    (_, want), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    b = DiGCN_Inception_Block(3, 8, device="cpu")
    b.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    outs = b(t(x), P1, P2)
    sum((o * t(g)).sum() for o, g in zip(outs, gs)).backward()
    for o, w in zip(outs, want):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(w), **TOL)
    assert_grads_match(b, jg)


@pytest.mark.parametrize("mode", TIERS)
def test_inception_node_classification(mode):
    (P1, P2), (J1, J2) = digcn_ops(mode)
    x = features()
    check(JxInceptionNode(num_features=2, hidden=16, label_dim=5),
          DiGCN_Inception_Block_node_classification(2, 16, 5, device="cpu"),
          (x, J1, J2), (t(x), P1, P2), 5, seed=4)


@pytest.mark.parametrize("mode", TIERS)
def test_inception_link_prediction(mode):
    (P1, P2), (J1, J2) = digcn_ops(mode)
    x, q = features(), queries(seed=5)
    check(JxInceptionLink(num_features=2, hidden=16, label_dim=3),
          DiGCN_Inception_Block_link_prediction(2, 16, 3, device="cpu"),
          (x, J1, J2), (t(x), P1, P2), 3, seed=5, query=q)


@pytest.mark.parametrize("mode", TIERS)
def test_dgcn_node_classification(mode):
    ops, jops = dgcn_ops(mode)
    x = features(seed=6)
    check(JxDGCNNode(num_features=2, hidden=16, label_dim=3),
          DGCN_node_classification(2, 16, 3, device="cpu"), (x, *jops),
          (t(x), *ops), 3, seed=6)


@pytest.mark.parametrize("mode", TIERS)
def test_dgcn_link_prediction(mode):
    ops, jops = dgcn_ops(mode)
    x, q = features(seed=7), queries(seed=7)
    check(JxDGCNLink(num_features=2, hidden=16, label_dim=2),
          DGCN_link_prediction(2, 16, 2, device="cpu"), (x, *jops),
          (t(x), *ops), 2, seed=7, query=q)


def test_state_dict_names():
    """The port's parameter names, which ``state_dict_from_jax`` maps the
    flax groups onto."""
    names = {
        DiGCN_link_prediction(2, 4, 2, device="cpu"): {
            "convs.0.linear.weight", "convs.0.bias", "convs.1.linear.weight",
            "convs.1.bias", "linear.weight", "linear.bias"},
        DGCN_node_classification(2, 4, 3, device="cpu"): {
            "trunk.linear.weight", "trunk.bias1", "trunk.linear1.weight",
            "trunk.bias2", "linear.weight", "linear.bias"},
    }
    for m, want in names.items():
        assert set(m.state_dict()) == want
    block = set(DiGCN_Inception_Block_node_classification(
        2, 4, 3, device="cpu").state_dict())
    assert {"blocks.2.linear.weight", "blocks.2.convs.1.bias"} <= block
    assert len(block) == 3 * 6


@pytest.mark.parametrize("cls", [
    DiGCN_node_classification, DiGCN_Inception_Block_node_classification,
    DGCN_node_classification])
def test_dropout_acts_only_when_training(cls):
    if cls is DGCN_node_classification:
        ops, _ = dgcn_ops("segment")
    else:
        ops, _ = digcn_ops("segment")
        ops = ops[:1] if cls is DiGCN_node_classification else ops
    m = cls(2, 8, 3, dropout=0.5, device="cpu",
            generator=torch.Generator().manual_seed(0))
    x = t(features())
    assert torch.equal(m(x, *ops), m(x, *ops))
    a = m(x, *ops, True, torch.Generator().manual_seed(1))
    b = m(x, *ops, True, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, m(x, *ops))


def test_dgcn_node_build_propagators():
    """The JAX experiment module's public ``build_propagators``: the same
    three operators, on the graph's own (unbinarized) weights."""
    ei, w, _ = digraph(seed=3)
    w = w * np.random.default_rng(3).uniform(0.5, 2.0, len(w))
    data = DirectedData(edge_index=ei, edge_weight=w)
    got = dgcn_node.build_propagators(data, N, device="cpu")
    want = jx_dgcn_node.build_propagators(data, N)
    x = features(f=3, seed=8)
    assert len(got) == len(want) == 3
    for P, J in zip(got, want):
        assert P.mode == J.mode
        np.testing.assert_allclose(P(t(x)).numpy(), np.asarray(J(x)),
                                   rtol=1e-6, atol=1e-6)
