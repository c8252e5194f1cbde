"""The attention tier and the propagator-set models across a mesh: the
port's 8-shard CPU mesh against the JAX package on its 8-device CPU mesh
(tests/conftest.py), at N=96 as tests/test_parallel_attn.py.

The sharded attention graph holds JAX's per-device edge sets; the sharded
apply matches the port's flat one at 1e-5 and JAX's sharded one (each shard
shifts by its own largest logit, as JAX's does); SNEA, GATConv, SiGAT and
SDGNN per motif on sharded graphs match the JAX models (weights carried
over by ``state_dict_from_jax``; JAX's attention on its "xla" backend) in
their output and every gradient at JAX's own tolerances for the same
checks.  The propagator-set models: tests/test_torch_parallel_models.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_signed_directed_tpu import graph as jx_graph
from pytorch_geometric_signed_directed_tpu.data import SSBM as JxSSBM
from pytorch_geometric_signed_directed_tpu.nn import (
    SDGNN as JxSDGNN, SGCN as JxSGCN, SNEA as JxSNEA, SiGAT as JxSiGAT,
    DiGCL as JxDiGCL, DIGRAC_node_clustering as JxDIGRAC,
    SSSNET_node_clustering as JxSSSNET)
from pytorch_geometric_signed_directed_tpu.nn.signed import (
    gat_conv as jx_gat_conv, sdgnn as jx_sdgnn, sgcn as jx_sgcn,
    sigat as jx_sigat, snea as jx_snea, snea_conv as jx_snea_conv)
from pytorch_geometric_signed_directed_tpu.parallel import (
    make_mesh as jx_make_mesh,
    shard_attention_graph as jx_shard_attention_graph,
    sharded_attention_apply as jx_sharded_attention_apply)

from pytorch_geometric_signed_directed_tpu_torch import graph, parallel
from pytorch_geometric_signed_directed_tpu_torch.convert import (
    state_dict_from_jax)
from pytorch_geometric_signed_directed_tpu_torch.nn import (
    SDGNN, SGCN, SNEA, DiGCL, DIGRAC_node_clustering, GATConv, SiGAT,
    SSSNET_node_clustering)
from pytorch_geometric_signed_directed_tpu_torch.nn.signed import (
    gat_conv, sdgnn, sgcn, sigat, snea, snea_conv)

from test_torch_worker_memory import release_memory  # noqa: F401

N = 96
F32_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
# SiGAT, SDGNN, SSSNET, DIGRAC and DiGCL's gradients: JAX's own 5e-4
WIDE_TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(scope="module")
def meshes():
    return parallel.make_mesh(8, device="cpu"), jx_make_mesh(8)


@pytest.fixture
def xla(monkeypatch):
    """JAX's flat attention on its segment ops (the port's sharded path is
    held against JAX's sharded Pallas path in the apply tests)."""
    monkeypatch.setattr(jx_snea_conv, "AGGREGATE_BACKEND", "xla")


@pytest.fixture(scope="module")
def signed_edges():
    """tests/test_parallel_attn.py's graph: SSBM(96, 2, 0.3, 0.1), as
    [M, 3] (src, dst, sign)."""
    (A_p, A_n), _ = JxSSBM(N, 2, 0.3, 0.1, size_ratio=1,
                           rng=np.random.default_rng(3))
    A = (A_p - A_n).tocoo()
    keep = A.data != 0
    return np.column_stack([A.row[keep], A.col[keep],
                            np.sign(A.data[keep])]).astype(np.int64)


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def load(module, params):
    """The JAX weights; a loss head that the forward's init does not make
    (SNEA's and SGCN's ``lsp_loss``) keeps the port's own."""
    missing, unexpected = module.load_state_dict(
        state_dict_from_jax(jax.device_get(params)), strict=False)
    assert not unexpected and all(k.startswith("lsp_loss.") for k in missing)
    return module


def perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.uniform(-0.3, 0.3, a.shape),
                                  jnp.float32), params)


def assert_grads_match(module, jax_grads, tol):
    want = state_dict_from_jax(jax.device_get(jax_grads))
    got = {k: torch.zeros_like(p) if p.grad is None else p.grad
           for k, p in module.named_parameters()
           if not k.startswith("lsp_loss.")}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **tol)


def jitted_value_and_grad(fn, scalar, params):
    """``fn(params)`` and the gradient of ``scalar(fn(params))``, jitted
    (JAX's eager dispatch of these models takes seconds)."""
    def both(p):
        out = fn(p)
        return scalar(out), out

    (_, out), grads = jax.jit(jax.value_and_grad(both, has_aux=True))(params)
    return out, grads


# --- the sharded graph and its apply -------------------------------------

GRAPHS = {
    # n not divisible by 8; every shard holds edges
    "uniform": dict(n=N, half=False),
    # destinations in the first half only: shards 4-7 have no edge, and
    # shard 3 owns rows past the last destination
    "edgeless shards": dict(n=90, half=True),
}


def attention_graphs(case, seed=0):
    n, half = GRAPHS[case]["n"], GRAPHS[case]["half"]
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, 700)
    dst = rng.integers(0, n // 2 if half else n, 700)
    edges = [(np.vstack([src, dst]), 0, False)]
    return (n, snea_conv.build_attention_graph(edges, n, device="cpu"),
            jx_snea_conv.build_attention_graph(edges, n))


@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_shard_edge_sets_match_jax(case, meshes):
    mesh, jmesh = meshes
    n, g, jg = attention_graphs(case)
    sg = parallel.shard_attention_graph(g, mesh)
    js = jx_shard_attention_graph(jg, jmesh)
    assert sg.rows_per_device == js.rows_per_device == -(-n // 8)
    sizes = []
    for d, sh in enumerate(sg.shards):
        valid = np.asarray(js.dst)[d] < n
        want = sorted(zip(np.asarray(js.src)[d][valid].tolist(),
                          np.asarray(js.dst)[d][valid].tolist(),
                          np.asarray(js.edge_p)[d][valid].tolist()))
        assert sorted(zip(sh.src.tolist(), sh.dst.tolist(),
                          sh.edge_p.tolist())) == want
        local = sh.dst - d * sg.rows_per_device
        assert torch.equal(sh.plan.row_ids, local)
        assert sh.plan.rowptr[-1].item() == len(want)
        sizes.append(len(want))
    assert sum(sizes) == g.src.numel()
    assert (0 in sizes) == (case == "edgeless shards")


@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_sharded_apply_matches_flat_and_jax(case, meshes):
    """Forward and the gradients of x and w: the port's sharded apply
    against its flat aggregate (1e-5) and JAX's sharded apply (1e-5).

    With edgeless shards JAX's gradients are NaN: its padding edges read
    x[0], its shift there is finfo.min, and the masked exp's cotangent is
    0 * inf.  The port's shards hold no padding (its edgeless shard shifts
    by 0), so there its gradients are held against the flat ones alone."""
    mesh, jmesh = meshes
    n, g, jg = attention_graphs(case, seed=1)
    sg = parallel.shard_attention_graph(g, mesh)
    jsg = jx_shard_attention_graph(jg, jmesh)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    gout = rng.standard_normal((n, 16)).astype(np.float32)

    def jsharded(xx, ww):
        def edge_fn(s, d, ep, valid):
            return xx[s] @ ww, xx[s]
        return jx_sharded_attention_apply(jsg, edge_fn)

    with jmesh:
        jout, vjp = jax.vjp(jax.jit(jsharded), jnp.asarray(x),
                            jnp.asarray(w))
        jgx, jgw = vjp(jnp.asarray(gout))
    res = {}
    for name in ("flat", "sharded"):
        xt, wt = t(x).requires_grad_(True), t(w).requires_grad_(True)
        if name == "flat":
            out = snea_conv.attention_softmax_aggregate(
                g, xt[g.src] @ wt, xt[g.src])
        else:
            out = parallel.sharded_attention_apply(
                sg, lambda s, d, ep, valid: (xt[s] @ wt, xt[s]))
        (out * t(gout)).sum().backward()
        res[name] = (out.detach(), xt.grad, wt.grad)
    for a, b in zip(res["sharded"], res["flat"]):
        torch.testing.assert_close(a, b, **F32_TOL)
    want = (jout, jgx, jgw)
    if case == "edgeless shards":
        assert not res["sharded"][0][n // 2:].any()
        assert np.isnan(np.asarray(jgw)).all()
        want = (jout,)
    for a, b in zip(res["sharded"], want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32_TOL)


@pytest.mark.parametrize("which", ["graph", "graphs"])
def test_a_motif_stack_cannot_be_sharded(which, signed_edges, meshes):
    x = np.zeros((N, 4), np.float32)
    stack = sigat.prepare_sigat_inputs(N, signed_edges, init_emb=x,
                                       fused=True, device="cpu")[3]
    fn = (parallel.shard_attention_graph if which == "graph"
          else parallel.shard_attention_graphs)
    with pytest.raises(TypeError, match="fused=False"):
        fn(stack, meshes[0])


# --- the attention models ------------------------------------------------

def test_sharded_snea_matches_jax(signed_edges, meshes, xla, monkeypatch):
    x = np.random.default_rng(4).standard_normal((N, 16)).astype(np.float32)
    pos, neg, _, graphs = snea.prepare_snea_inputs(N, signed_edges,
                                                   init_emb=x, device="cpu")
    _, _, _, jgraphs = jx_snea.prepare_snea_inputs(N, signed_edges,
                                                   init_emb=x)
    sgraphs = parallel.shard_attention_graphs(graphs, meshes[0])
    assert isinstance(sgraphs, tuple) and len(sgraphs) == 3
    jm = JxSNEA(node_num=N, in_dim=16, out_dim=16, layer_num=2, init_emb=x)
    params = perturbed(jm.init(jax.random.PRNGKey(0), jgraphs), 5)
    jz, jg = jitted_value_and_grad(
        lambda p: jm.apply(p, jgraphs), lambda z: jnp.sum(z ** 2), params)
    m = load(SNEA(N, in_dim=16, out_dim=16, layer_num=2, init_emb=x,
                  device="cpu"), params)
    assert m.convs[0].fused

    def no_pair(*a, **k):
        raise AssertionError("a sharded g_cat took the fused pair path")

    monkeypatch.setattr(snea_conv, "_attend_pair", no_pair)
    z = m(sgraphs)
    (z ** 2).sum().backward()
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz),
                               **MODEL_TOL)
    assert_grads_match(m, jg, MODEL_TOL)


def test_sharded_gatconv_matches_jax(meshes, xla):
    rng = np.random.default_rng(1)
    ei = np.vstack([rng.integers(0, N, 500), rng.integers(0, N, 500)])
    g = gat_conv.gat_graph(ei, N, device="cpu")
    jg = jx_gat_conv.gat_graph(ei, N)
    x = rng.standard_normal((N, 8)).astype(np.float32)
    jm = jx_gat_conv.GATConv(8)
    params = perturbed(jm.init(jax.random.PRNGKey(0), x, jg), 6)

    jout, (jgp, jgx) = jitted_value_and_grad(
        lambda px: jm.apply(px[0], px[1], jg), lambda z: jnp.sum(z ** 2),
        (params, jnp.asarray(x)))
    m = load(GATConv(8, 8, device="cpu"), params)
    xt = t(x).requires_grad_(True)
    out = m(xt, parallel.shard_attention_graph(g, meshes[0]))
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **MODEL_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **MODEL_TOL)
    assert_grads_match(m, jgp, MODEL_TOL)


def test_sharded_sigat_matches_jax(signed_edges, meshes, xla):
    x = np.random.default_rng(7).standard_normal((N, 8)).astype(np.float32)
    pos, neg, _, graphs = sigat.prepare_sigat_inputs(N, signed_edges,
                                                     init_emb=x, device="cpu")
    _, _, _, jgraphs = jx_sigat.prepare_sigat_inputs(N, signed_edges,
                                                     init_emb=x)
    sgraphs = parallel.shard_attention_graphs(graphs, meshes[0])
    assert isinstance(sgraphs, list) and len(sgraphs) == 38
    jm = JxSiGAT(node_num=N, in_dim=8, out_dim=8, init_emb=x)
    params = perturbed(jm.init(jax.random.PRNGKey(0), jgraphs), 8)
    # eager: 38 motif graphs take longer to compile than to dispatch
    jz = jm.apply(params, jgraphs)
    jl, jg = jax.value_and_grad(lambda p: jm.apply(
        p, jgraphs, pos, neg, method=JxSiGAT.loss))(params)
    m = load(SiGAT(N, in_dim=8, out_dim=8, init_emb=x, device="cpu"),
             params)
    np.testing.assert_allclose(m(sgraphs).detach().numpy(), np.asarray(jz),
                               **MODEL_TOL)
    loss = m.loss(sgraphs, pos, neg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **MODEL_TOL)
    assert_grads_match(m, jg, WIDE_TOL)


def test_sharded_sdgnn_matches_jax(signed_edges, meshes, xla):
    x = np.random.default_rng(9).standard_normal((N, 8)).astype(np.float32)
    pos, neg, _, graphs, w_pos, w_neg = sdgnn.prepare_sdgnn_inputs(
        N, signed_edges, init_emb=x, device="cpu")
    jgraphs = jx_sdgnn.prepare_sdgnn_inputs(N, signed_edges, init_emb=x)[3]
    sgraphs = parallel.shard_attention_graphs(graphs, meshes[0])
    jm = JxSDGNN(node_num=N, in_dim=8, out_dim=8, layer_num=2, init_emb=x)
    args = (pos, neg, w_pos, w_neg)
    params = perturbed(jm.init(jax.random.PRNGKey(0), jgraphs, *args,
                               method=JxSDGNN.loss), 10)
    jz = jax.jit(lambda p: jm.apply(p, jgraphs))(params)
    jl, jg = jitted_value_and_grad(lambda p: jm.apply(
        p, jgraphs, *args, method=JxSDGNN.loss), lambda l: l, params)
    m = load(SDGNN(N, in_dim=8, out_dim=8, layer_num=2, init_emb=x,
                   device="cpu"), params)
    np.testing.assert_allclose(m(sgraphs).detach().numpy(), np.asarray(jz),
                               **MODEL_TOL)
    loss = m.loss(sgraphs, *args)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **MODEL_TOL)
    assert_grads_match(m, jg, WIDE_TOL)
