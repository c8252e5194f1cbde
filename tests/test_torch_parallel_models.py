"""The propagator-set models on sharded propagators: SGCN (segment and
mxu), SSSNET, DIGRAC and DiGCL's contrastive loss on the port's 8-shard CPU
mesh against the JAX models on their flat segment operators (weights
carried over by ``state_dict_from_jax``), at N=96 and the tolerances of
tests/test_parallel_attn.py: outputs 2e-4, gradients 2e-4 (SGCN) or
5e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_signed_directed_tpu import graph as jx_graph
from pytorch_geometric_signed_directed_tpu.nn import (
    SGCN as JxSGCN, DiGCL as JxDiGCL, DIGRAC_node_clustering as JxDIGRAC,
    SSSNET_node_clustering as JxSSSNET)
from pytorch_geometric_signed_directed_tpu.nn.signed import sgcn as jx_sgcn

from pytorch_geometric_signed_directed_tpu_torch import graph, parallel
from pytorch_geometric_signed_directed_tpu_torch.nn import (
    SGCN, DiGCL, DIGRAC_node_clustering, SSSNET_node_clustering)
from pytorch_geometric_signed_directed_tpu_torch.nn.signed import sgcn

# the helpers and the signed_edges fixture of the attention tests
from test_torch_parallel_attn import (  # noqa: F401
    MODEL_TOL, N, WIDE_TOL, assert_grads_match, jitted_value_and_grad, load,
    perturbed, signed_edges, t)

from test_torch_worker_memory import release_memory  # noqa: F401

@pytest.fixture(scope="module")
def mesh():
    return parallel.make_mesh(8, device="cpu")


@pytest.mark.parametrize("mode", ["segment", "mxu"])
def test_sharded_sgcn_matches_jax(mode, signed_edges, mesh):
    x = np.random.default_rng(11).standard_normal((N, 16)).astype(np.float32)
    got = sgcn.prepare_sgcn_inputs(N, signed_edges, in_dim=16, init_emb=x,
                                   mode=mode, device="cpu")
    want = jx_sgcn.prepare_sgcn_inputs(N, signed_edges, in_dim=16,
                                       init_emb=x, mode="segment")
    P_pos, P_neg = (parallel.shard_propagator(P, mesh)
                    for P in got[3:5])
    assert P_pos.mode == ("mxu_sharded" if mode == "mxu" else "segment")
    jm = JxSGCN(node_num=N, in_dim=16, out_dim=16, layer_num=2, init_emb=x)
    params = perturbed(jm.init(jax.random.PRNGKey(0), want[3], want[4]), 12)
    jz, jg = jitted_value_and_grad(lambda p: jm.apply(p, want[3], want[4]),
                                   lambda z: jnp.sum(z ** 2), params)
    m = load(SGCN(N, in_dim=16, out_dim=16, layer_num=2, init_emb=x,
                  device="cpu"), params)
    z = m(P_pos, P_neg)
    (z ** 2).sum().backward()
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz),
                               **MODEL_TOL)
    assert_grads_match(m, jg, MODEL_TOL)


def walk_operators(ei, w, fills, mode):
    """rw_norm_propagator of each (edge_index, fill) in both packages; the
    JAX ones on the segment tier."""
    return ([graph.rw_norm_propagator(e, w, N, fill_value=f, mode=mode,
                                      device="cpu") for e, f in zip(ei, fills)],
            [jx_graph.rw_norm_propagator(e, w, N, fill_value=f,
                                         mode="segment")
             for e, f in zip(ei, fills)])


def check_clustering(jm, jops, m, ops, x, seed):
    params = perturbed(jm.init(jax.random.PRNGKey(0), *jops, x), seed)

    jout, jg = jitted_value_and_grad(lambda p: jm.apply(p, *jops, x),
                                     lambda out: jnp.sum(out[1] ** 2), params)
    m = load(m, params)
    out = m(*ops, t(x))
    (out[1] ** 2).sum().backward()
    for i in (0, 1, 3):
        np.testing.assert_allclose(out[i].detach().numpy(),
                                   np.asarray(jout[i]), **MODEL_TOL)
    assert_grads_match(m, jg, WIDE_TOL)


def test_sharded_sssnet_matches_jax(signed_edges, mesh):
    es = signed_edges
    pos, neg = es[es[:, 2] > 0, :2].T, es[es[:, 2] < 0, :2].T
    rng = np.random.default_rng(13)
    x = rng.standard_normal((N, 4)).astype(np.float32)
    ops, jops = [], []
    for e, fill in ((pos, 0.5), (neg, 0.0)):
        w = np.ones(e.shape[1])
        (P,), (J,) = walk_operators([e], w, [fill], "mxu")
        ops.append(parallel.shard_propagator(P, mesh))
        jops.append(J)
    check_clustering(JxSSSNET(nfeat=4, hidden=8, nclass=2), jops,
                     SSSNET_node_clustering(nfeat=4, hidden=8, nclass=2,
                                            device="cpu"), ops, x, 14)


def test_sharded_digrac_matches_jax(mesh):
    rng = np.random.default_rng(2)
    src, dst = rng.integers(0, N, 600), rng.integers(0, N, 600)
    keep = src != dst
    ei = np.vstack([src[keep], dst[keep]])
    w = rng.uniform(0.5, 1.5, ei.shape[1])
    x = rng.standard_normal((N, 4)).astype(np.float32)
    ops, jops = walk_operators([ei, ei[[1, 0]]], w, [0.5, 0.5], "mxu")
    ops = [parallel.shard_propagator(P, mesh) for P in ops]
    check_clustering(JxDIGRAC(num_features=4, hidden=8, nclass=3), jops,
                     DIGRAC_node_clustering(num_features=4, hidden=8,
                                            nclass=3, device="cpu"),
                     ops, x, 15)


def test_sharded_digcl_loss_matches_jax(mesh):
    rng = np.random.default_rng(7)
    src, dst = rng.integers(0, N, 700), rng.integers(0, N, 700)
    keep = src != dst
    ei = np.vstack([src[keep], dst[keep]])
    w = rng.uniform(0.5, 1.5, ei.shape[1])
    x = rng.standard_normal((N, 12)).astype(np.float32)
    views = [graph.gcn_norm_propagator(e, w, N, mode="mxu", device="cpu")
             for e in (ei, ei[[1, 0]])]
    jviews = [jx_graph.gcn_norm_propagator(e, w, N, mode="segment")
              for e in (ei, ei[[1, 0]])]
    S1, S2 = (parallel.shard_propagator(P, mesh) for P in views)
    kw = dict(in_channels=12, activation="relu", num_hidden=8,
              num_proj_hidden=8, tau=0.4, num_layers=2)
    jm = JxDiGCL(**kw)
    params = perturbed(jm.init(jax.random.PRNGKey(0), x, jviews[0],
                               method=JxDiGCL.warmup), 16)

    def jcontrastive(p):
        z1, z2 = (jm.apply(p, x, P) for P in jviews)
        return jm.apply(p, z1, z2, method=JxDiGCL.loss)

    jl, jg = jitted_value_and_grad(jcontrastive, lambda l: l, params)
    m = load(DiGCL(device="cpu", **kw), params)
    loss = m.loss(m(t(x), S1), m(t(x), S2))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **MODEL_TOL)
    assert_grads_match(m, jg, WIDE_TOL)
