"""Port MagNet layers and model vs the JAX package, with the same weights
carried over by ``state_dict_from_jax``: forward outputs and every
parameter gradient, on the dense, segment and kernel ("mxu", "bsr")
tiers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_signed_directed_tpu.nn import (
    MagNetConv as JxMagNetConv,
    MagNet_link_prediction as JxMagNetLink,
    MagNet_node_classification as JxMagNetNode)
from pytorch_geometric_signed_directed_tpu.spectral import (
    magnet_propagators as jx_magnet_propagators)

from pytorch_geometric_signed_directed_tpu_torch.convert import (
    state_dict_from_jax)
from pytorch_geometric_signed_directed_tpu_torch.nn import (
    MagNetConv, MagNet_link_prediction, MagNet_node_classification)
from pytorch_geometric_signed_directed_tpu_torch.spectral import (
    magnet_propagators, magnetic_laplacian)

from test_torch_worker_memory import release_memory  # noqa: F401

# the tolerance of the JAX package's own MagNet parity test: Chebyshev
# recurrences and einsums in float32, summed in other orders
TOL = dict(rtol=2e-4, atol=2e-4)
TIERS = ["dense", "segment", "mxu", "bsr"]


def graph(n, e, seed):
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n, e)
    col = rng.integers(0, n, e)
    keep = row != col
    row, col = row[keep], col[keep]
    return np.stack([row, col]), rng.uniform(0.5, 1.5, len(row))


def both_laps(ei, w, n, mode):
    return (magnet_propagators(ei, w, q=0.25, num_nodes=n, mode=mode,
                               device="cpu"),
            jx_magnet_propagators(ei, w, q=0.25, num_nodes=n, mode=mode))


def t(a, grad=False):
    return torch.from_numpy(np.asarray(a, np.float32)).requires_grad_(grad)


def assert_grads_match(module, jax_grads):
    want = state_dict_from_jax(jax.device_get(jax_grads))
    got = {k: p.grad for k, p in module.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("mode", TIERS)
@pytest.mark.parametrize("K", [1, 2, 3])
def test_magnetconv_forward_and_grads(K, mode):
    n, f_in, f_out = 60, 3, 5
    ei, w = graph(n, 400, seed=K)
    lap, jlap = both_laps(ei, w, n, mode)
    rng = np.random.default_rng(10 + K)
    x_re, x_im = (rng.standard_normal((n, f_in)).astype(np.float32)
                  for _ in range(2))
    g_re, g_im = (rng.standard_normal((n, f_out)).astype(np.float32)
                  for _ in range(2))

    jconv = JxMagNetConv(in_channels=f_in, out_channels=f_out, K=K)
    params = jconv.init(jax.random.PRNGKey(K), x_re, x_im, jlap)

    def jloss(p):
        o_re, o_im = jconv.apply(p, x_re, x_im, jlap)
        return jnp.sum(o_re * g_re) + jnp.sum(o_im * g_im), (o_re, o_im)

    (_, (want_re, want_im)), jgrads = jax.value_and_grad(
        jloss, has_aux=True)(params)

    conv = MagNetConv(f_in, f_out, K, device="cpu")
    conv.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    out_re, out_im = conv(t(x_re), t(x_im), lap)
    ((out_re * t(g_re)).sum() + (out_im * t(g_im)).sum()).backward()

    np.testing.assert_allclose(out_re.detach().numpy(), want_re, **TOL)
    np.testing.assert_allclose(out_im.detach().numpy(), want_im, **TOL)
    assert_grads_match(conv, jgrads)


@pytest.mark.parametrize("mode", TIERS)
def test_magnet_node_classification_forward_and_grads(mode):
    n = 80
    ei, w = graph(n, 600, seed=5)
    lap, jlap = both_laps(ei, w, n, mode)
    rng = np.random.default_rng(5)
    x = rng.random((n, 2)).astype(np.float32)
    y = rng.integers(0, 5, n)

    jmodel = JxMagNetNode(num_features=2, hidden=16, K=2, label_dim=5,
                          activation=True, layer=2)
    params = jmodel.init(jax.random.PRNGKey(0), x, x, jlap)

    def jloss(p):
        logp = jmodel.apply(p, x, x, jlap)
        return -jnp.mean(logp[jnp.arange(n), y]), logp

    (jl, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)

    model = MagNet_node_classification(
        num_features=2, hidden=16, K=2, label_dim=5, activation=True,
        layer=2, device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    logp = model(t(x), t(x), lap)
    loss = torch.nn.functional.nll_loss(logp, torch.from_numpy(y))
    loss.backward()

    np.testing.assert_allclose(logp.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    assert_grads_match(model, jgrads)


def test_magnet_link_prediction_forward_and_grads():
    n = 60
    ei, w = graph(n, 400, seed=8)
    lap, jlap = both_laps(ei, w, n, "mxu")
    rng = np.random.default_rng(8)
    x = rng.random((n, 2)).astype(np.float32)
    q = rng.integers(0, n, (30, 2))
    y = rng.integers(0, 2, 30)

    jmodel = JxMagNetLink(num_features=2, hidden=8, K=1, label_dim=2,
                          activation=True, layer=2)
    params = jmodel.init(jax.random.PRNGKey(1), x, x, jlap, q)

    def jloss(p):
        logp = jmodel.apply(p, x, x, jlap, q)
        return -jnp.mean(logp[jnp.arange(30), y]), logp

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)

    model = MagNet_link_prediction(num_features=2, hidden=8, K=1,
                                   label_dim=2, activation=True, layer=2,
                                   device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    logp = model(t(x), t(x), lap, torch.from_numpy(q))
    torch.nn.functional.nll_loss(logp, torch.from_numpy(y)).backward()
    np.testing.assert_allclose(logp.detach().numpy(), want, **TOL)
    assert_grads_match(model, jgrads)


def test_dropout_uses_the_generator():
    n = 40
    ei, w = graph(n, 200, seed=2)
    lap = magnet_propagators(ei, w, num_nodes=n, mode="segment",
                             device="cpu")
    model = MagNet_node_classification(2, hidden=4, K=1, label_dim=3,
                                       dropout=0.5, device="cpu",
                                       generator=torch.Generator()
                                       .manual_seed(0))
    x = torch.rand(n, 2)

    def run(seed, training=True):
        return model(x, x, lap, training=training,
                     generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    assert torch.equal(run(1, False), run(2, False))


# --- the original layer's 4-stream recurrence, verbatim (as in
# tests/test_magnet_parity.py), against the port ------------------------

def reference_forward(L_re, L_im, x_real, x_imag, weight, bias):
    """Verbatim 4-stream Chebyshev loop of the reference.

    The reference's propagate applies L^T: its flow='target_to_source'
    setdefault runs after super().__init__ (dead code), so PyG's default
    source_to_target flow aggregates out[tgt] += norm * x[src].
    """
    def prop(L, v):
        return L.T @ v

    K1 = weight.shape[0]
    Tx_0_rr, Tx_0_ii = x_real, x_imag
    Tx_0_ir, Tx_0_ri = x_real, x_imag
    out_rr = Tx_0_rr @ weight[0]
    out_ii = Tx_0_ii @ weight[0]
    out_ir = Tx_0_ir @ weight[0]
    out_ri = Tx_0_ri @ weight[0]

    if K1 > 1:
        Tx_1_rr = prop(L_re, x_real)
        out_rr = out_rr + Tx_1_rr @ weight[1]
        Tx_1_ii = prop(L_im, x_imag)
        out_ii = out_ii + Tx_1_ii @ weight[1]
        Tx_1_ir = prop(L_re, x_real)
        out_ir = out_ir + Tx_1_ir @ weight[1]
        Tx_1_ri = prop(L_im, x_imag)
        out_ri = out_ri + Tx_1_ri @ weight[1]

    for k in range(2, K1):
        Tx_2_rr = 2.0 * prop(L_re, Tx_1_rr) - Tx_0_rr
        out_rr = out_rr + Tx_2_rr @ weight[k]
        Tx_0_rr, Tx_1_rr = Tx_1_rr, Tx_2_rr
        Tx_2_ii = 2.0 * prop(L_im, Tx_1_ii) - Tx_0_ii
        out_ii = out_ii + Tx_2_ii @ weight[k]
        Tx_0_ii, Tx_1_ii = Tx_1_ii, Tx_2_ii
        Tx_2_ir = 2.0 * prop(L_re, Tx_1_ir) - Tx_0_ir
        out_ir = out_ir + Tx_2_ir @ weight[k]
        Tx_0_ir, Tx_1_ir = Tx_1_ir, Tx_2_ir
        Tx_2_ri = 2.0 * prop(L_im, Tx_1_ri) - Tx_0_ri
        out_ri = out_ri + Tx_2_ri @ weight[k]
        Tx_0_ri, Tx_1_ri = Tx_1_ri, Tx_2_ri

    out_real = out_rr - out_ii + bias
    out_imag = out_ir + out_ri + bias
    return out_real, out_imag


@pytest.mark.parametrize("mode", TIERS)
@pytest.mark.parametrize("K", [1, 2, 3])
def test_magnetconv_matches_reference_recurrence(K, mode):
    rng = np.random.default_rng(K)
    n, f_in, f_out = 40, 6, 5
    ei, w = graph(n, 150, seed=K)
    lap = magnet_propagators(ei, w, q=0.25, num_nodes=n, mode=mode,
                             device="cpu")
    # raw (untransposed) scaled Laplacian, duplicates summed
    ei_l, wre, wim = magnetic_laplacian(ei, w, "sym", n, 0.25)
    L_re = np.zeros((n, n))
    np.add.at(L_re, (ei_l[0], ei_l[1]), wre)
    L_re -= np.eye(n)  # 2L/lambda - I with lambda = 2
    L_im = np.zeros((n, n))
    np.add.at(L_im, (ei_l[0], ei_l[1]), wim)

    x_re = rng.standard_normal((n, f_in)).astype(np.float32)
    x_im = rng.standard_normal((n, f_in)).astype(np.float32)
    conv = MagNetConv(f_in, f_out, K, device="cpu",
                      generator=torch.Generator().manual_seed(K))
    with torch.no_grad():
        conv.bias.normal_(generator=torch.Generator().manual_seed(K))
        out_re, out_im = conv(t(x_re), t(x_im), lap)

    weight = conv.weight.detach().numpy().astype(np.float64)
    bias = conv.bias.detach().numpy().astype(np.float64)
    ref_re, ref_im = reference_forward(L_re, L_im, x_re.astype(np.float64),
                                       x_im.astype(np.float64), weight, bias)
    np.testing.assert_allclose(out_re.numpy(), ref_re, **TOL)
    np.testing.assert_allclose(out_im.numpy(), ref_im, **TOL)
