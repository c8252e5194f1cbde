"""SNEAConv and SNEA in the port vs the JAX package, with the same weights
carried over by ``state_dict_from_jax``: every output and every gradient
(inputs and parameters) at 2e-4, on both aggregates (the port's "mxu",
K1, against JAX's Pallas scatter plan in interpret mode; the port's
"segment" against JAX's "xla" backend), with the fused pair path where
4 out <= 128 and two attends where it is wider; then five Adam steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_signed_directed_tpu.nn import (
    SNEA as JxSNEA, SNEAConv as JxSNEAConv)
from pytorch_geometric_signed_directed_tpu.nn.signed import (
    snea as jx_snea, snea_conv as jx_snea_conv)
from pytorch_geometric_signed_directed_tpu.train import Trainer as JxTrainer
from pytorch_geometric_signed_directed_tpu.utils import (
    negative_sampling as jx_negative_sampling,
    structured_negative_sampling as jx_structured)

from pytorch_geometric_signed_directed_tpu_torch.convert import (
    state_dict_from_jax)
from pytorch_geometric_signed_directed_tpu_torch.nn import SNEA, SNEAConv
from pytorch_geometric_signed_directed_tpu_torch.nn.signed import snea
from pytorch_geometric_signed_directed_tpu_torch.train import Trainer
from pytorch_geometric_signed_directed_tpu_torch.utils import (
    negative_sampling, structured_negative_sampling)

MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
# (the port's aggregate, the JAX backend)
AGGREGATES = [("mxu", "mxu"), ("segment", "xla")]


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def signed_edge_list(n=60, m=400, seed=0):
    """[M, 3] uniform draws with duplicates and self-loops, as bench.py's
    ``_signed_edge_array``."""
    rng = np.random.default_rng(seed)
    return np.column_stack([rng.integers(0, n, m), rng.integers(0, n, m),
                            np.where(rng.random(m) < 0.75, 1, -1)]), n


def perturbed(params, rng):
    """Weights moved off their initial values (the biases start at 0)."""
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


def graphs(es, n):
    pos, neg, _, got = snea.prepare_snea_inputs(n, es, init_emb=np.zeros(
        (n, 1), np.float32), device="cpu")
    want = jx_snea_conv.snea_graphs(pos, neg, n)
    return pos, neg, got, want


@pytest.mark.parametrize("out_dim", [6, 40])
@pytest.mark.parametrize("first_aggr", [True, False])
@pytest.mark.parametrize("aggregate,backend", AGGREGATES)
def test_snea_conv_forward_and_grads(aggregate, backend, first_aggr,
                                     out_dim, monkeypatch):
    monkeypatch.setattr(jx_snea_conv, "AGGREGATE_BACKEND", backend)
    es, n = signed_edge_list(seed=1)
    _, _, got, want = graphs(es, n)
    rng = np.random.default_rng(2)
    f = 5
    width = f if first_aggr else 2 * f
    x = rng.standard_normal((n, width)).astype(np.float32)
    g = rng.standard_normal((n, 2 * out_dim)).astype(np.float32)
    jm = JxSNEAConv(f, out_dim, first_aggr=first_aggr)
    params = perturbed(jm.init(jax.random.PRNGKey(3), x, *want), rng)

    def jloss(p, xx):
        out = jm.apply(p, xx, *want)
        return jnp.sum(out * g), out

    (_, jout), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, x)
    m = load(SNEAConv(f, out_dim, first_aggr, aggregate=aggregate,
                      device="cpu"), params)
    assert m.fused == (not first_aggr and aggregate == "mxu"
                       and out_dim == 6)
    xt = t(x).requires_grad_(True)
    out = m(xt, *got)
    (out * t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **MODEL_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **MODEL_TOL)
    assert_grads_match(m, jg)


def test_fused_and_unfused_snea_conv_agree():
    es, n = signed_edge_list(seed=4)
    _, _, got, _ = graphs(es, n)
    x = t(np.random.default_rng(5).standard_normal((n, 8)))
    fused = SNEAConv(4, 6, False, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    unfused = SNEAConv(4, 6, False, aggregate="segment", device="cpu")
    unfused.load_state_dict(fused.state_dict())
    assert fused.fused and not unfused.fused
    np.testing.assert_allclose(fused(x, *got).detach().numpy(),
                               unfused(x, *got).detach().numpy(), rtol=1e-5,
                               atol=1e-5)


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


def snea_case(seed, in_dim=6):
    es, n = signed_edge_list(seed=seed)
    pos, neg, got, want = graphs(es, n)
    x = np.random.default_rng(seed + 1).standard_normal(
        (n, in_dim)).astype(np.float32)
    jsamp = samples(pos, neg, n, seed + 2, jax_side=True)
    psamp = samples(pos, neg, n, seed + 2, jax_side=False)
    for a, b in zip((jsamp[0], *jsamp[1], *jsamp[2]),
                    (psamp[0], *psamp[1], *psamp[2])):
        np.testing.assert_array_equal(a, b)
    return n, x, pos, neg, got, want, jsamp, psamp


@pytest.mark.parametrize("init_emb_grad", [True, False])
@pytest.mark.parametrize("layer_num,out_dim", [(2, 8), (3, 8), (2, 70)])
@pytest.mark.parametrize("aggregate,backend", AGGREGATES)
def test_snea_loss_and_grads(aggregate, backend, layer_num, out_dim,
                             init_emb_grad, monkeypatch):
    monkeypatch.setattr(jx_snea_conv, "AGGREGATE_BACKEND", backend)
    n, x, pos, neg, got, want, jsamp, psamp = snea_case(6)
    kw = dict(node_num=n, in_dim=6, out_dim=out_dim, layer_num=layer_num,
              lamb=4.0, init_emb_grad=init_emb_grad)
    jm = JxSNEA(init_emb=x, **kw)
    args = (want, pos, neg, *jsamp)
    params = perturbed(jm.init(jax.random.PRNGKey(7), *args,
                               method=JxSNEA.loss), np.random.default_rng(8))
    jl, jg = jax.value_and_grad(
        lambda p: jm.apply(p, *args, method=JxSNEA.loss))(params)
    jz = jm.apply(params, want)
    m = load(SNEA(init_emb=x, aggregate=aggregate, device="cpu", **kw),
             params)
    z = m(got)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz),
                               **MODEL_TOL)
    loss = m.loss(got, pos, neg, *psamp)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **MODEL_TOL)
    assert_grads_match(m, jg)
    assert ("x" in dict(m.named_parameters())) == init_emb_grad


def test_snea_five_adam_steps_match_jax():
    n, x, pos, neg, got, want, jsamp, psamp = snea_case(9)
    kw = dict(node_num=n, in_dim=6, out_dim=8, layer_num=2)
    jm = JxSNEA(init_emb=x, **kw)
    args = (want, pos, neg, *jsamp)
    params = jm.init(jax.random.PRNGKey(10), *args, method=JxSNEA.loss)
    jt = JxTrainer(lambda p: jm.apply(p, *args, method=JxSNEA.loss),
                   lr=1e-2)
    js = jt.init(params)
    jlosses = [jt.step(js) for _ in range(5)]
    m = load(SNEA(init_emb=x, device="cpu", **kw), params)
    tr = Trainer(lambda mo: mo.loss(got, pos, neg, *psamp), lr=1e-2,
                 device="cpu")
    st = tr.init(m)
    losses = [tr.step(st) for _ in range(5)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-5)
    assert losses[-1] < losses[0]
    want_sd = state_dict_from_jax(jax.device_get(js.params))
    for k, v in m.state_dict().items():
        if k.startswith(NOISE_ONLY):
            continue
        np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


# The first layer's attention weights get no gradient: each destination
# aggregates its own feature (the reference's x_i quirk) over edges that
# all carry it, so the softmax weights cannot move the output.  Adam
# scales their rounding noise up to full steps, differently in each
# package, so the five-step test leaves them out.
NOISE_ONLY = ("conv1.alpha_b.", "conv1.alpha_u.")


def test_the_first_layer_attention_gets_no_gradient():
    n, x, pos, neg, got, want, jsamp, psamp = snea_case(9)
    kw = dict(node_num=n, in_dim=6, out_dim=8, layer_num=2)
    jm = JxSNEA(init_emb=x, **kw)
    args = (want, pos, neg, *jsamp)
    params = jm.init(jax.random.PRNGKey(10), *args, method=JxSNEA.loss)
    jg = state_dict_from_jax(jax.device_get(jax.grad(
        lambda p: jm.apply(p, *args, method=JxSNEA.loss))(params)))
    m = load(SNEA(init_emb=x, device="cpu", **kw), params)
    m.loss(got, pos, neg, *psamp).backward()
    for k, p in m.named_parameters():
        if k.startswith(NOISE_ONLY):
            assert float(p.grad.abs().max()) < 1e-5, k
            assert float(jg[k].abs().max()) < 1e-5, k
        elif k.startswith("convs.0.alpha"):
            assert float(p.grad.abs().max()) > 1e-3, k


def test_snea_graphs_match_jax():
    es, n = signed_edge_list(seed=11)
    _, _, got, want = graphs(es, n)
    for g, jg, flagged in zip(got, want, (False, False, True)):
        valid = np.asarray(jg.dst) < n
        assert sorted(zip(g.src.tolist(), g.dst.tolist(),
                          g.edge_p.tolist())) == sorted(zip(
                              np.asarray(jg.src)[valid].tolist(),
                              np.asarray(jg.dst)[valid].tolist(),
                              np.asarray(jg.edge_p)[valid].tolist()))
        assert bool(g.edge_p.any()) == flagged


def test_snea_needs_an_embedding_and_trains_a_copy():
    with pytest.raises(ValueError, match="init_emb"):
        SNEA(10, device="cpu")
    emb = np.ones((3, 4), np.float32)
    m = SNEA(3, in_dim=4, out_dim=4, init_emb=emb, device="cpu")
    with torch.no_grad():
        m.x.add_(1.0)
    np.testing.assert_array_equal(emb, np.ones((3, 4), np.float32))


def test_prepare_snea_inputs_builds_the_spectral_embedding():
    es, n = signed_edge_list(seed=12)
    got = snea.prepare_snea_inputs(n, es, in_dim=5, device="cpu")
    want = jx_snea.prepare_snea_inputs(n, es, in_dim=5)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
