"""DiGCL in the port vs the JAX package, with the same weights carried over
by ``state_dict_from_jax``: the encoder for each activation on the dense
and kernel ("mxu") tiers, ``semi_loss``, ``batched_semi_loss`` with a
padded last batch, ``loss`` in both forms, every parameter gradient, and
five Adam steps with coupled weight decay; ``drop_feature``; the graph
views ``cal_fast_appr`` builds at the alphas the experiments visit."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_geometric_signed_directed_tpu import graph as jx_graph
from pytorch_geometric_signed_directed_tpu.data import DSBM as jx_DSBM
from pytorch_geometric_signed_directed_tpu.experiments.digcl_node import (
    curriculum_alpha as jx_curriculum_alpha)
from pytorch_geometric_signed_directed_tpu.nn import DiGCL as JxDiGCL
from pytorch_geometric_signed_directed_tpu.spectral import (
    cal_fast_appr as jx_cal_fast_appr)
from pytorch_geometric_signed_directed_tpu.utils import (
    meta_graph_generation as jx_meta_graph_generation)

from pytorch_geometric_signed_directed_tpu_torch import graph
from pytorch_geometric_signed_directed_tpu_torch.convert import (
    state_dict_from_jax)
from pytorch_geometric_signed_directed_tpu_torch.experiments.digcl_node import (
    curriculum_alpha)
from pytorch_geometric_signed_directed_tpu_torch.nn import DiGCL
from pytorch_geometric_signed_directed_tpu_torch.spectral import (
    cal_fast_appr)
from pytorch_geometric_signed_directed_tpu_torch.train import Trainer
from pytorch_geometric_signed_directed_tpu_torch.utils import drop_feature

from test_torch_worker_memory import release_memory  # noqa: F401

# float32 forward, losses and gradients
TOL = dict(rtol=1e-5, atol=1e-5)
# five Adam steps
STEP_TOL = dict(rtol=2e-4, atol=2e-4)
N = 50
F_IN = 3


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def digraph(n=N, seed=0):
    F = jx_meta_graph_generation("cyclic", 3, 0.05, False)
    A, _ = jx_DSBM(n, 3, 0.2, F, rng=np.random.default_rng(seed))
    A = A.tocoo()
    return np.vstack([A.row, A.col]).astype(np.int64), A.data


def views(mode, alpha=0.1, n=N):
    """The view at ``alpha``, GCN-normalized, as (port, JAX)
    Propagators."""
    ei, w = digraph(n)
    e1, w1 = cal_fast_appr(alpha, ei, n, w)
    je1, jw1 = jx_cal_fast_appr(alpha, ei, n, w)
    return (graph.gcn_norm_propagator(e1, w1, n, mode=mode, device="cpu"),
            jx_graph.gcn_norm_propagator(je1, jw1, n, mode=mode))


def models(activation="relu", hidden=8, proj=6, layers=2, seed=0):
    jm = JxDiGCL(in_channels=F_IN, activation=activation, num_hidden=hidden,
                 num_proj_hidden=proj, tau=0.4, num_layers=layers)
    _, jP = views("dense")
    x = np.random.default_rng(seed).normal(size=(N, F_IN)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), jP,
                     method=JxDiGCL.warmup)
    # move the PReLU slope and the biases off their initial constants, so
    # that their gradients are tested away from 0.25 and 0
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jnp.asarray(np.random.default_rng(1).normal(
            size=a.shape), a.dtype), params)
    model = DiGCL(in_channels=F_IN, activation=activation, num_hidden=hidden,
                  num_proj_hidden=proj, tau=0.4, num_layers=layers,
                  device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    return jm, params, model, x


def grads_match(model, jgrads):
    want = state_dict_from_jax(jax.device_get(jgrads))
    # a parameter the output does not reach has no grad here, zeros there
    got = {k: torch.zeros_like(p) if p.grad is None else p.grad
           for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k in got:
        torch.testing.assert_close(got[k], want[k], **TOL, msg=k)


def test_state_dict_names_match_the_module():
    _, params, model, _ = models("prelu", layers=3)
    assert set(state_dict_from_jax(jax.device_get(params))) == set(
        dict(model.named_parameters()))
    assert [tuple(c.linear.weight.shape) for c in model.encoder.convs] == [
        (16, F_IN), (16, 16), (8, 16)]


@pytest.mark.parametrize("activation", ["relu", "prelu", "rrelu"])
@pytest.mark.parametrize("mode", ["dense", "mxu"])
def test_encoder_forward_and_gradients(activation, mode):
    jm, params, model, x = models(activation)
    P, jP = views(mode)
    g = np.random.default_rng(2).normal(size=(N, 8)).astype(np.float32)

    def jf(p):
        return (jm.apply(p, jnp.asarray(x), jP) * g).sum()

    jz = jm.apply(params, jnp.asarray(x), jP)
    z = model(t(x), P)
    torch.testing.assert_close(z, t(jz), **TOL)
    (z * t(g)).sum().backward()
    grads_match(model, jax.grad(jf)(params))


def embeddings(seed=3, n=N, width=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, width)).astype(np.float32),
            rng.normal(size=(n, width)).astype(np.float32))


def test_sim_and_semi_loss():
    jm, params, model, _ = models()
    a, b = embeddings()
    torch.testing.assert_close(DiGCL.sim(t(a), t(b)),
                               t(JxDiGCL.sim(jnp.asarray(a),
                                             jnp.asarray(b))), **TOL)
    za, zb = t(a).requires_grad_(), t(b).requires_grad_()
    got = model.semi_loss(za, zb)
    want, vjp = jax.vjp(lambda u, v: jm.apply(
        params, u, v, method=JxDiGCL.semi_loss), jnp.asarray(a),
        jnp.asarray(b))
    torch.testing.assert_close(got, t(want), **TOL)
    w = np.random.default_rng(4).normal(size=N).astype(np.float32)
    (got * t(w)).sum().backward()
    ga, gb = vjp(jnp.asarray(w))
    torch.testing.assert_close(za.grad, t(ga), **TOL)
    torch.testing.assert_close(zb.grad, t(gb), **TOL)


@pytest.mark.parametrize("batch_size", [16, 50, 64])
def test_batched_semi_loss_pads_the_last_batch(batch_size):
    """N=50: B=16 pads the 4th batch with 14 rows, 50 has none, and 64
    pads one batch; the padded rows' losses are 0 and cut off."""
    jm, params, model, _ = models()
    a, b = embeddings()
    za, zb = t(a).requires_grad_(), t(b).requires_grad_()
    got = model.batched_semi_loss(za, zb, batch_size)
    want, vjp = jax.vjp(lambda u, v: jm.apply(
        params, u, v, batch_size, method=JxDiGCL.batched_semi_loss),
        jnp.asarray(a), jnp.asarray(b))
    n_pad = ((N - 1) // batch_size + 1) * batch_size
    assert got.shape == want.shape == (n_pad,)
    torch.testing.assert_close(got, t(want), **TOL)
    assert torch.all(got[N:] == 0)
    w = np.random.default_rng(5).normal(size=n_pad).astype(np.float32)
    (got * t(w)).sum().backward()
    ga, gb = vjp(jnp.asarray(w))
    torch.testing.assert_close(za.grad, t(ga), **TOL)
    torch.testing.assert_close(zb.grad, t(gb), **TOL)


@pytest.mark.parametrize("batch_size", [0, 16])
@pytest.mark.parametrize("mean", [True, False])
def test_loss_and_every_gradient(batch_size, mean):
    jm, params, model, _ = models("prelu")
    a, b = embeddings()
    got = model.loss(t(a), t(b), mean=mean, batch_size=batch_size)

    def jf(p):
        return jm.apply(p, jnp.asarray(a), jnp.asarray(b), mean, batch_size,
                        method=JxDiGCL.loss)

    torch.testing.assert_close(got, t(jf(params)), **TOL)
    got.backward()
    jgrads = jax.grad(jf)(params)
    want = state_dict_from_jax(jax.device_get(jgrads))
    for name in ("fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"):
        torch.testing.assert_close(dict(model.named_parameters())[name].grad,
                                   want[name], **TOL, msg=name)


def test_batched_loss_gradient_through_the_checkpoint():
    """The whole step's gradient, encoder included, with the batched loss
    recomputed in the backward."""
    jm, params, model, x = models("rrelu")
    P1, jP1 = views("dense", 0.1)
    P2, jP2 = views("dense", 1.7)
    x2 = 0.9 * x

    def jf(p):
        z1 = jm.apply(p, jnp.asarray(x), jP1)
        z2 = jm.apply(p, jnp.asarray(x2), jP2)
        return jm.apply(p, z1, z2, batch_size=16, method=JxDiGCL.loss)

    loss = model.loss(model(t(x), P1), model(t(x2), P2), batch_size=16)
    torch.testing.assert_close(loss, t(jf(params)), **TOL)
    loss.backward()
    grads_match(model, jax.grad(jf)(params))


def test_five_adam_steps_with_weight_decay():
    """The experiments' optimizer: coupled L2 (optax's
    add_decayed_weights before adam) as the port's Trainer."""
    jm, params, model, x = models("prelu")
    P1, jP1 = views("dense", 0.1)
    P2, jP2 = views("dense", curriculum_alpha("log", 0, 5))
    rng = np.random.default_rng(6)
    masks = [(rng.random(F_IN) < 0.3, rng.random(F_IN) < 0.4)
             for _ in range(5)]
    tx = optax.chain(optax.add_decayed_weights(5e-4), optax.adam(1e-2))
    opt = tx.init(params)
    jlosses = []
    for m1, m2 in masks:
        def jf(p):
            z1 = jm.apply(p, jnp.asarray(np.where(m1, 0.0, x)), jP1)
            z2 = jm.apply(p, jnp.asarray(np.where(m2, 0.0, x)), jP2)
            return jm.apply(p, z1, z2, method=JxDiGCL.loss)

        loss, grads = jax.value_and_grad(jf)(params)
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        jlosses.append(float(loss))

    def loss_fn(m, x1, x2):
        return m.loss(m(x1, P1), m(x2, P2))

    trainer = Trainer(loss_fn, lr=1e-2, weight_decay=5e-4, device="cpu")
    state = trainer.init(model)
    losses = [trainer.step(state, t(np.where(m1, 0.0, x)),
                           t(np.where(m2, 0.0, x))) for m1, m2 in masks]
    np.testing.assert_allclose(losses, jlosses, **STEP_TOL)
    want = state_dict_from_jax(jax.device_get(params))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k], **STEP_TOL, msg=k)


def test_drop_feature_zeroes_whole_columns():
    x = torch.arange(1, 1 + 40 * 30, dtype=torch.float32).view(40, 30)
    out = drop_feature(x, 0.4, torch.Generator().manual_seed(0))
    gone = (out == 0).all(0)
    assert torch.equal(out[:, ~gone], x[:, ~gone])
    assert 0 < int(gone.sum()) < 30
    # the mask is uniform < p over columns, from the generator
    want = torch.rand(30, generator=torch.Generator().manual_seed(0)) < 0.4
    assert torch.equal(gone, want)
    assert torch.equal(drop_feature(x, 0.0), x)
    assert torch.all(drop_feature(x, 1.0) == 0)
    same = drop_feature(x, 0.4, torch.Generator().manual_seed(0))
    assert torch.equal(same, out)


@pytest.mark.parametrize("alpha", [0.1, 1.7, 0.9,
                                   float(jx_curriculum_alpha("log", 7, 20))])
def test_views_bit_equal_at_the_curriculum_alphas(alpha):
    """The views digcl_node and digcl_link build, at alpha_1 = 0.1, the
    log schedule's start 1.7 (alpha > 1), the fixed 0.9 and a later log
    value; and the dense operators on them."""
    ei, w = digraph(120, seed=4)
    e, v = cal_fast_appr(alpha, ei, 120, w)
    je, jv = jx_cal_fast_appr(alpha, ei, 120, w)
    assert e.dtype == je.dtype and v.dtype == jv.dtype
    np.testing.assert_array_equal(e, je)
    np.testing.assert_array_equal(v, jv)
    P = graph.gcn_norm_propagator(e, v, 120, mode="dense", device="cpu")
    jP = jx_graph.gcn_norm_propagator(je, jv, 120, mode="dense")
    np.testing.assert_array_equal(P.dense.numpy(), np.asarray(jP.dense))


@pytest.mark.parametrize("kind", ["linear", "exp", "log", "fixed"])
def test_curriculum_alpha_matches(kind):
    for epoch in range(0, 30, 3):
        assert curriculum_alpha(kind, epoch, 30) == float(
            jx_curriculum_alpha(kind, epoch, 30))
    if kind == "log":
        assert curriculum_alpha(kind, 0, 200) > 1.69
