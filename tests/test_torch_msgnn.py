"""Port MSConv and the MSGNN models vs the JAX package, with the same
weights carried over by ``state_dict_from_jax``: every output and every
parameter gradient, on the dense, segment and kernel ("mxu", "bsr")
tiers of the signed magnetic Laplacian."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_signed_directed_tpu.nn import (
    MSConv as JxMSConv,
    MSGNN_link_prediction as JxMSGNNLink,
    MSGNN_node_classification as JxMSGNNNode)
from pytorch_geometric_signed_directed_tpu.nn.normalize import (
    l2_normalize as jx_l2_normalize)
from pytorch_geometric_signed_directed_tpu.spectral import (
    magnet_propagators as jx_magnet_propagators)

from pytorch_geometric_signed_directed_tpu_torch.convert import (
    state_dict_from_jax)
from pytorch_geometric_signed_directed_tpu_torch.nn import (
    MSConv, MSGNN_link_prediction, MSGNN_node_classification, l2_normalize)
from pytorch_geometric_signed_directed_tpu_torch.spectral import (
    magnet_propagators)

from test_torch_worker_memory import release_memory  # noqa: F401

# the tolerance of tests/test_torch_magnet.py
TOL = dict(rtol=2e-4, atol=2e-4)
TIERS = ["dense", "segment", "mxu", "bsr"]


def signed_graph(n, e, seed):
    rng = np.random.default_rng(seed)
    row, col = rng.integers(0, n, e), rng.integers(0, n, e)
    keep = row != col
    row, col = row[keep], col[keep]
    w = rng.uniform(0.5, 1.5, len(row)) * rng.choice([-1.0, 1.0], len(row))
    return np.stack([row, col]), w


def both_laps(ei, w, n, mode, q=0.25, absolute_degree=True):
    kw = dict(q=q, num_nodes=n, mode=mode, signed=True,
              absolute_degree=absolute_degree)
    return (magnet_propagators(ei, w, device="cpu", **kw),
            jx_magnet_propagators(ei, w, **kw))


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def assert_grads_match(module, jax_grads):
    want = state_dict_from_jax(jax.device_get(jax_grads))
    got = {k: p.grad for k, p in module.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("mode", TIERS)
@pytest.mark.parametrize("K,absolute_degree", [(1, True), (2, False),
                                               (3, True)])
def test_msconv_forward_and_grads(K, absolute_degree, mode):
    n, f_in, f_out = 50, 4, 6
    ei, w = signed_graph(n, 350, seed=K)
    lap, jlap = both_laps(ei, w, n, mode, absolute_degree=absolute_degree)
    rng = np.random.default_rng(20 + K)
    x_re, x_im, g_re, g_im = (
        rng.standard_normal((n, f)).astype(np.float32)
        for f in (f_in, f_in, f_out, f_out))

    jconv = JxMSConv(in_channels=f_in, out_channels=f_out, K=K,
                     absolute_degree=absolute_degree)
    params = jconv.init(jax.random.PRNGKey(K), x_re, x_im, jlap)

    def jloss(p):
        o_re, o_im = jconv.apply(p, x_re, x_im, jlap)
        return jnp.sum(o_re * g_re) + jnp.sum(o_im * g_im), (o_re, o_im)

    (_, (want_re, want_im)), jgrads = jax.value_and_grad(
        jloss, has_aux=True)(params)

    conv = MSConv(f_in, f_out, K, absolute_degree=absolute_degree,
                  device="cpu")
    assert conv.absolute_degree is absolute_degree
    conv.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    out_re, out_im = conv(t(x_re), t(x_im), lap)
    ((out_re * t(g_re)).sum() + (out_im * t(g_im)).sum()).backward()

    np.testing.assert_allclose(out_re.detach().numpy(), want_re, **TOL)
    np.testing.assert_allclose(out_im.detach().numpy(), want_im, **TOL)
    assert_grads_match(conv, jgrads)


@pytest.mark.parametrize("mode", TIERS)
def test_msgnn_node_classification_forward_and_grads(mode):
    n, label_dim = 70, 3
    ei, w = signed_graph(n, 500, seed=5)
    lap, jlap = both_laps(ei, w, n, mode)
    rng = np.random.default_rng(5)
    x = rng.random((n, 4)).astype(np.float32)
    y = rng.integers(0, label_dim, n)
    gz = rng.standard_normal((n, 32)).astype(np.float32)
    gp = rng.standard_normal((n, label_dim)).astype(np.float32)

    jmodel = JxMSGNNNode(num_features=4, hidden=16, K=2, q=0.25,
                         label_dim=label_dim)
    params = jmodel.init(jax.random.PRNGKey(0), x, x, jlap)

    def jloss(p):
        z, logp, pred, prob = jmodel.apply(p, x, x, jlap)
        loss = (-jnp.mean(logp[jnp.arange(n), y]) + jnp.sum(z * gz)
                + jnp.sum(prob * gp))
        return loss, (z, logp, pred, prob)

    (jl, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)

    model = MSGNN_node_classification(num_features=4, hidden=16, K=2,
                                      q=0.25, label_dim=label_dim,
                                      device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    got = model(t(x), t(x), lap)
    z, logp, pred, prob = got
    loss = (torch.nn.functional.nll_loss(logp, torch.from_numpy(y))
            + (z * t(gz)).sum() + (prob * t(gp)).sum())
    loss.backward()

    assert len(got) == 4
    for a, b in ((z, want[0]), (logp, want[1]), (prob, want[3])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    assert_grads_match(model, jgrads)


@pytest.mark.parametrize("mode", TIERS)
def test_msgnn_link_prediction_forward_and_grads(mode):
    n, label_dim = 60, 4
    ei, w = signed_graph(n, 400, seed=8)
    lap, jlap = both_laps(ei, w, n, mode, q=0.0)
    rng = np.random.default_rng(8)
    x = rng.random((n, 4)).astype(np.float32)
    q = rng.integers(0, n, (40, 2))
    y = rng.integers(0, label_dim, 40)
    gz = rng.standard_normal((40, 4 * 8)).astype(np.float32)

    jmodel = JxMSGNNLink(num_features=4, hidden=8, K=1, q=0.0,
                         label_dim=label_dim)
    params = jmodel.init(jax.random.PRNGKey(1), x, x, jlap, q)

    def jloss(p):
        logp, z = jmodel.apply(p, x, x, jlap, q)
        return (-jnp.mean(logp[jnp.arange(40), y]) + jnp.sum(z * gz),
                (logp, z))

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)

    model = MSGNN_link_prediction(num_features=4, hidden=8, K=1, q=0.0,
                                  label_dim=label_dim, device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    logp, z = model(t(x), t(x), lap, torch.from_numpy(q))
    (torch.nn.functional.nll_loss(logp, torch.from_numpy(y))
     + (z * t(gz)).sum()).backward()
    np.testing.assert_allclose(logp.detach().numpy(), np.asarray(want[0]),
                               **TOL)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(want[1]), **TOL)
    assert_grads_match(model, jgrads)


def test_state_dict_from_jax_reads_msgnn_trees():
    x = np.zeros((10, 4), np.float32)
    ei, w = signed_graph(10, 30, seed=1)
    jlap = jx_magnet_propagators(ei, w, num_nodes=10, signed=True)
    params = JxMSGNNNode(num_features=4, hidden=5, K=2, label_dim=3,
                         layer=3).init(jax.random.PRNGKey(0), x, x, jlap)
    assert set(params["params"]) == {"_MSGNNTrunk_0", "Dense_0"}
    sd = state_dict_from_jax(jax.device_get(params))
    model = MSGNN_node_classification(4, hidden=5, K=2, label_dim=3,
                                      layer=3, device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    np.testing.assert_array_equal(
        model.convs[2].weight.detach().numpy(),
        np.asarray(params["params"]["_MSGNNTrunk_0"]["MSConv_2"]["weight"]))


def test_msgnn_dropout_uses_the_generator():
    n = 40
    ei, w = signed_graph(n, 200, seed=2)
    lap = magnet_propagators(ei, w, num_nodes=n, mode="segment",
                             signed=True, device="cpu")
    model = MSGNN_node_classification(4, hidden=4, K=1, label_dim=3,
                                      device="cpu",
                                      generator=torch.Generator()
                                      .manual_seed(0))
    x = torch.rand(n, 4)

    def run(seed, training=True):
        return model(x, x, lap, training=training,
                     generator=torch.Generator().manual_seed(seed))[1]

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    assert torch.equal(run(1, False), run(2, False))


def test_l2_normalize_matches_jax_at_a_zero_row():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 6)).astype(np.float32)
    x[2] = 0.0
    g = rng.standard_normal((5, 6)).astype(np.float32)
    want, jvjp = jax.vjp(jx_l2_normalize, x)
    xt = t(x).requires_grad_(True)
    got = l2_normalize(xt)
    (got * t(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jvjp(g)[0]),
                               rtol=1e-6, atol=1e-7)
    assert np.all(got.detach().numpy()[2] == 0)
    # the rsqrt(sumsq + eps) gradient at the zero row is g / sqrt(eps),
    # where F.normalize's is g / eps
    np.testing.assert_allclose(xt.grad.numpy()[2], g[2] * 1e6, rtol=1e-6)
