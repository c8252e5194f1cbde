"""The motif models in the port vs the JAX package: SiGAT's 38 and SDGNN's
4 motif edge lists and the triangle weights bit-equal; GATConv; SiGAT and
SDGNN forward, loss and every gradient at 2e-4 with the weights carried
over by ``state_dict_from_jax``, one GAT a motif (both aggregates) and the
fused motif stack; the stack against the port's own per-motif path; and
``motif_attend``'s hand-written backward against autograd of the plain
composition."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_signed_directed_tpu.nn import (
    SDGNN as JxSDGNN, SiGAT as JxSiGAT)
from pytorch_geometric_signed_directed_tpu.nn.signed import (
    gat_conv as jx_gat_conv, motifs as jx_motifs, sdgnn as jx_sdgnn,
    sigat as jx_sigat, snea_conv as jx_snea_conv)

from pytorch_geometric_signed_directed_tpu_torch.convert import (
    state_dict_from_jax)
from pytorch_geometric_signed_directed_tpu_torch.nn import (
    SDGNN, GATConv, SiGAT)
from pytorch_geometric_signed_directed_tpu_torch.nn.signed import (
    gat_conv, motif_stack, motifs, sdgnn, sigat)
from pytorch_geometric_signed_directed_tpu_torch.ops import segment

from test_torch_worker_memory import release_memory  # noqa: F401

MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
AGGREGATES = [("mxu", "mxu"), ("segment", "xla")]


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def signed_edges(n=40, m=260, seed=0, neg_share=0.3, both_signs=True):
    """[M, 3] uniform draws with duplicates and self-loops; with
    ``both_signs`` some pairs carry both signs."""
    rng = np.random.default_rng(seed)
    es = np.column_stack([rng.integers(0, n, m), rng.integers(0, n, m),
                          np.where(rng.random(m) < neg_share, -1, 1)])
    if both_signs:
        flip = es[:12].copy()
        flip[:, 2] *= -1
        es = np.vstack([es, flip])
    return es.astype(np.int64), n


EDGE_CASES = {
    "both signs": dict(seed=1),
    "one sign a pair": dict(seed=2, both_signs=False),
    "no negative edge": dict(seed=3, neg_share=0.0, both_signs=False),
    "dense": dict(n=12, m=200, seed=4),
}


def perturbed(params, rng):
    return jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.uniform(-0.3, 0.3, a.shape),
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


# --- the motif edge lists ----------------------------------------------------

@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_sigat_edge_lists_are_bit_equal(case):
    es, n = signed_edges(**EDGE_CASES[case])
    got = motifs.sigat_edge_lists(es, n)
    want = jx_motifs.sigat_edge_lists(es, n)
    assert len(got) == len(want) == 38
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype, i
        np.testing.assert_array_equal(a, b, err_msg=str(i))
    assert sum(e.shape[1] for e in got[6:]) > 0 or case == "no negative edge"


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_sdgnn_edge_lists_and_triangle_weights_are_bit_equal(case):
    es, n = signed_edges(**EDGE_CASES[case])
    got, gw = motifs.sdgnn_edge_lists(es, n)
    want, jw = jx_motifs.sdgnn_edge_lists(es, n)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert gw.format == jw.format == "csc"
    for attr in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(gw, attr), getattr(jw, attr))
    assert gw.data.dtype == jw.data.dtype


def test_a_pair_of_both_signs_keeps_its_negative_count():
    es, n = signed_edges(**EDGE_CASES["both signs"])
    _, w = motifs.sdgnn_edge_lists(es, n)
    pos = {tuple(p) for p in es[es[:, 2] > 0][:, :2]}
    neg = {tuple(p) for p in es[es[:, 2] < 0][:, :2]}
    both = sorted(p for p in pos & neg if p[0] != p[1])
    assert both
    # the pair is stored once, with the negative mask's count
    P, N, _, _ = motifs._bool_adjs(es, n)
    mats = motifs._tri_products(P, N)
    for u, v in both:
        want = sum(m * M[u, v] for m, M in zip(motifs._SDGNN_MASK_NEG, mats))
        assert w[u, v] == want


# --- GATConv -----------------------------------------------------------------

@pytest.mark.parametrize("aggregate,backend", AGGREGATES)
def test_gat_conv_forward_and_grads(aggregate, backend, monkeypatch):
    monkeypatch.setattr(jx_snea_conv, "AGGREGATE_BACKEND", backend)
    es, n = signed_edges(seed=5)
    ei = es[:, :2].T
    g = gat_conv.gat_graph(ei, n, device="cpu")
    jg = jx_gat_conv.gat_graph(ei, n)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((n, 7)).astype(np.float32)
    gout = rng.standard_normal((n, 5)).astype(np.float32)
    jm = jx_gat_conv.GATConv(5)
    params = perturbed(jm.init(jax.random.PRNGKey(0), x, jg), rng)

    def jloss(p, xx):
        out = jm.apply(p, xx, jg)
        return jnp.sum(out * gout), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, x)
    m = load(GATConv(7, 5, aggregate=aggregate, device="cpu"), params)
    xt = t(x).requires_grad_(True)
    out = m(xt, g)
    (out * t(gout)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **MODEL_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **MODEL_TOL)
    assert_grads_match(m, jgp)


# --- SiGAT and SDGNN ---------------------------------------------------------

def model_case(seed, n=30, m=180):
    es, n = signed_edges(n=n, m=m, seed=seed)
    x = np.random.default_rng(seed + 1).standard_normal(
        (n, 6)).astype(np.float32)
    return es, n, x


@pytest.mark.parametrize("init_emb_grad", [True, False])
@pytest.mark.parametrize("fused,aggregate,backend",
                         [(False, "mxu", "mxu"), (False, "segment", "xla"),
                          (True, "mxu", "mxu")])
def test_sigat_loss_and_grads(fused, aggregate, backend, init_emb_grad,
                              monkeypatch):
    monkeypatch.setattr(jx_snea_conv, "AGGREGATE_BACKEND", backend)
    es, n, x = model_case(7)
    pos, neg, _, graphs = sigat.prepare_sigat_inputs(
        n, es, init_emb=x, fused=fused, device="cpu")
    _, _, _, jgraphs = jx_sigat.prepare_sigat_inputs(n, es, init_emb=x,
                                                     fused=fused)
    kw = dict(node_num=n, in_dim=6, out_dim=5, init_emb_grad=init_emb_grad)
    jm = JxSiGAT(init_emb=x, **kw)
    params = perturbed(jm.init(jax.random.PRNGKey(1), jgraphs, pos, neg,
                               method=JxSiGAT.loss),
                       np.random.default_rng(2))
    jl, jg = jax.value_and_grad(
        lambda p: jm.apply(p, jgraphs, pos, neg, method=JxSiGAT.loss))(params)
    jz = jm.apply(params, jgraphs)
    m = load(SiGAT(init_emb=x, fused=fused, aggregate=aggregate,
                   device="cpu", **kw), params)
    z = m(graphs)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz),
                               **MODEL_TOL)
    loss = m.loss(graphs, pos, neg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **MODEL_TOL)
    assert_grads_match(m, jg)


@pytest.mark.parametrize("layer_num", [1, 2])
@pytest.mark.parametrize("fused,aggregate,backend",
                         [(False, "mxu", "mxu"), (False, "segment", "xla"),
                          (True, "mxu", "mxu")])
def test_sdgnn_loss_and_grads(fused, aggregate, backend, layer_num,
                              monkeypatch):
    monkeypatch.setattr(jx_snea_conv, "AGGREGATE_BACKEND", backend)
    es, n, x = model_case(8)
    got = sdgnn.prepare_sdgnn_inputs(n, es, init_emb=x, fused=fused,
                                     device="cpu")
    want = jx_sdgnn.prepare_sdgnn_inputs(n, es, init_emb=x, fused=fused)
    pos, neg, _, graphs, w_pos, w_neg = got
    for a, b in zip((pos, neg, w_pos, w_neg),
                    (want[0], want[1], want[4], want[5])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert w_pos.dtype == np.float32 and w_pos.any()
    kw = dict(node_num=n, in_dim=6, out_dim=5, layer_num=layer_num)
    jm = JxSDGNN(init_emb=x, **kw)
    args = (want[3], pos, neg, w_pos, w_neg)
    params = perturbed(jm.init(jax.random.PRNGKey(3), *args,
                               method=JxSDGNN.loss),
                       np.random.default_rng(4))
    jl, jg = jax.value_and_grad(
        lambda p: jm.apply(p, *args, method=JxSDGNN.loss))(params)
    jz = jm.apply(params, want[3])
    m = load(SDGNN(init_emb=x, fused=fused, aggregate=aggregate,
                   device="cpu", **kw), params)
    z = m(graphs)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz),
                               **MODEL_TOL)
    loss = m.loss(graphs, pos, neg, w_pos, w_neg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **MODEL_TOL)
    assert_grads_match(m, jg)


@pytest.mark.parametrize("model", ["sigat", "sdgnn"])
def test_the_stack_matches_the_per_motif_path(model):
    """The same weights (``stack_state_dict``): the same loss, and the
    stack's gradients are the per-motif ones stacked."""
    es, n, x = model_case(9)
    if model == "sigat":
        cls, prep = SiGAT, sigat.prepare_sigat_inputs
        kw = {}
    else:
        cls, prep = SDGNN, sdgnn.prepare_sdgnn_inputs
        kw = dict(layer_num=2)
    lists_in = prep(n, es, init_emb=x, device="cpu")
    stack_in = prep(n, es, init_emb=x, fused=True, device="cpu")
    kw.update(node_num=n, in_dim=6, out_dim=5, init_emb=x, device="cpu")
    per = cls(generator=torch.Generator().manual_seed(0), **kw)
    fused = cls(fused=True, **kw)
    fused.load_state_dict(motif_stack.stack_state_dict(per.state_dict()))
    args = lambda inputs: (inputs[3], *inputs[:2], *inputs[4:])  # noqa: E731
    a, b = per.loss(*args(lists_in)), fused.loss(*args(stack_in))
    np.testing.assert_allclose(a.item(), b.item(), rtol=1e-5)
    a.backward()
    b.backward()
    want = motif_stack.stack_state_dict(
        {k: p.grad for k, p in per.named_parameters()})
    got = {k: p.grad for k, p in fused.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **MODEL_TOL)


def test_a_model_refuses_the_other_form_of_graphs():
    es, n, x = model_case(10)
    _, _, _, stack = sigat.prepare_sigat_inputs(n, es, init_emb=x,
                                                fused=True, device="cpu")
    with pytest.raises(TypeError, match="MotifStackGraph"):
        SiGAT(n, in_dim=6, out_dim=5, init_emb=x, device="cpu")(stack)


# --- motif_attend ------------------------------------------------------------

def plain_attend(slope, ms, T, a_src, a_dst):
    """The motif attend composed of differentiable torch ops (autograd
    takes the backward)."""
    g = ms.g
    pre = a_src[g.src] + a_dst[g.dst]
    logit = torch.where(pre >= 0, pre, slope * pre)
    ex = torch.exp(logit - logit.max())
    stacked = torch.cat([ex[:, None], T[g.src] * ex[:, None]], 1)
    agg = segment.segment_sum(stacked, g.dst, g.num_nodes)
    return agg[:, 1:] / agg[:, :1].clamp_min(torch.finfo(T.dtype).tiny)


def test_motif_attend_backward_matches_autograd():
    es, n = signed_edges(n=20, m=120, seed=11)
    lists = motifs.sigat_edge_lists(es, n)[:7]
    ms = motif_stack.build_motif_stack(lists, n, device="cpu")
    G, f = len(lists), 4
    rng = np.random.default_rng(12)
    T = t(rng.standard_normal((G * n, f)))
    a_src = t(rng.standard_normal(G * n))
    a_dst = t(rng.standard_normal(G * n))
    gout = t(rng.standard_normal((G * n, f)))
    ins = [v.clone().requires_grad_(True) for v in (T, a_src, a_dst)]
    out = motif_stack.motif_attend(0.2, ms, *ins)
    (out * gout).sum().backward()
    ref = [v.clone().requires_grad_(True) for v in (T, a_src, a_dst)]
    want = plain_attend(0.2, ms, *ref)
    (want * gout).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    for a, b, name in zip(ins, ref, ("T", "a_src", "a_dst")):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def attend_case(seed, dtype=torch.float32):
    es, n = signed_edges(n=20, m=120, seed=seed)
    lists = motifs.sigat_edge_lists(es, n)[:7]
    ms = motif_stack.build_motif_stack(lists, n, device="cpu")
    rng = np.random.default_rng(seed + 1)
    GN, f = len(lists) * n, 4

    def draw(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=dtype)

    return ms, (draw(GN, f), draw(GN), draw(GN)), draw(GN, f)


def test_motif_attend_gradients_match_float64_autograd():
    """Forward and backward (the indexed sums and the edge kernel's plain
    versions) in float64 against autograd of the plain composition."""
    ms, ins0, gout = attend_case(21, torch.float64)
    ins = [v.clone().requires_grad_(True) for v in ins0]
    out = motif_stack.motif_attend(0.2, ms, *ins)
    (out * gout).sum().backward()
    ref = [v.clone().requires_grad_(True) for v in ins0]
    want = plain_attend(0.2, ms, *ref)
    (want * gout).sum().backward()
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               rtol=1e-12, atol=1e-12)
    for a, b, name in zip(ins, ref, ("T", "a_src", "a_dst")):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


def test_attend_logit_grad_plain_is_the_backward_composition():
    """The edge kernel's plain version is the PyTorch composition that
    the backward ran before it, bit for bit."""
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        attend_grad)

    ms, (T, a_src, a_dst), dout = attend_case(23)
    g = ms.g
    pre = a_src[g.src] + a_dst[g.dst]
    rng = np.random.default_rng(24)
    out = t(rng.standard_normal(tuple(T.shape)))
    alpha = t(rng.random(g.src.numel()))
    dl = alpha * ((T[g.src] - out[g.dst]) * dout[g.dst]).sum(dim=1)
    want = dl * torch.where(pre >= 0, 1.0, 0.2)
    got = attend_grad.attend_logit_grad(g.dst, g.src, T, out, dout, alpha,
                                        pre, 0.2)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_motif_stack_plans_the_backward_index():
    """The sum by source reads dout at each source-CSR slot's destination:
    ``dst_by_src`` is the destination of the forward edge ``src_perm``
    names, slot for slot."""
    ms, _, _ = attend_case(25)
    np.testing.assert_array_equal(ms.dst_by_src.numpy(),
                                  ms.g.dst[ms.src_perm].numpy())
    assert ms.dst_by_src.dtype == torch.int64
    np.testing.assert_array_equal(ms.g.src[ms.src_perm].numpy(),
                                  ms.src_plan.row_ids.numpy())


def test_motif_stack_matches_jax():
    es, n = signed_edges(n=20, m=120, seed=13)
    lists = motifs.sigat_edge_lists(es, n)
    ms = motif_stack.build_motif_stack(lists, n, device="cpu")
    jms = jx_sigat.build_motif_stack(lists, n)
    GN = len(lists) * n
    valid = np.asarray(jms.g.dst) < GN
    assert sorted(zip(ms.g.src.tolist(), ms.g.dst.tolist())) == sorted(zip(
        np.asarray(jms.g.src)[valid].tolist(),
        np.asarray(jms.g.dst)[valid].tolist()))
    # the source CSR: G N rows and the empty trash row; its slots list the
    # forward edges by source
    assert ms.src_plan.num_rows == GN + 1
    assert int(ms.src_plan.rowptr[-1]) == int(ms.src_plan.rowptr[-2])
    src = ms.g.src[ms.src_perm]
    np.testing.assert_array_equal(src.numpy(), ms.src_plan.row_ids.numpy())
    assert sorted(ms.src_perm.tolist()) == list(range(ms.g.src.numel()))
