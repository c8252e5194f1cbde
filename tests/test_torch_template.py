"""Trainable q in the port against the JAX package, on the CPU: the
template arrays, the template applies (dense, segment, and the kernel
tier's flat, column-split and streamed layouts, with the layout knobs
lowered on both packages' modules), the trainable-q MagNet model with
every gradient (q included) and five Adam steps, and the clip's gradient
at the bounds of q."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_signed_directed_tpu.nn import (
    MagNetConv as JxMagNetConv,
    MagNet_node_classification as JxMagNetNode)
from pytorch_geometric_signed_directed_tpu.ops import spmm as jx_spmm
from pytorch_geometric_signed_directed_tpu.ops.pallas import scatter_mxu
from pytorch_geometric_signed_directed_tpu.spectral import (
    magnetic_template as jx_magnetic_template,
    template_dual as jx_template_dual,
    template_dual_apply as jx_template_dual_apply,
    template_propagators as jx_template_propagators)
from pytorch_geometric_signed_directed_tpu.train import Trainer as JxTrainer

from pytorch_geometric_signed_directed_tpu_torch.convert import (
    state_dict_from_jax)
from pytorch_geometric_signed_directed_tpu_torch.nn import (
    MagNetConv, MagNet_node_classification)
from pytorch_geometric_signed_directed_tpu_torch.ops import layout, spmm
from pytorch_geometric_signed_directed_tpu_torch.spectral import (
    magnetic as magnetic_mod, magnetic_template, template_dual,
    template_dual_apply, template_propagators)
from pytorch_geometric_signed_directed_tpu_torch.train import Trainer

from test_torch_worker_memory import release_memory  # noqa: F401

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# dq sums g * y' over every node and lane, in another order
DQ_TOL = dict(rtol=1e-4, atol=1e-5)
# the model: Chebyshev recurrences and einsums summed in other orders
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

SPLIT = dict(COL_SPLIT_MIN_COLS=100, GATHER_FAST_ROWS=64,
             COL_SPLIT_MIN_COVERAGE=0.0)
STREAM = dict(STREAM_THRESHOLD_EDGES=1000, STREAM_BLOCK_EDGES=2048)
KINDS = {"flat": {}, "split": SPLIT, "streamed": STREAM,
         "split_streamed": {**SPLIT, **STREAM}}


@pytest.fixture
def knobs(monkeypatch):
    def set_(**values):
        for k, v in values.items():
            monkeypatch.setattr(layout, k, v)
            monkeypatch.setattr(scatter_mxu, k, v)
    return set_


def zipf_graph(n, e, seed, signed=False):
    rng = np.random.default_rng(seed)
    ei = np.vstack([rng.integers(0, n, e), (rng.zipf(1.3, e) - 1) % n])
    w = rng.random(e).astype(np.float32)
    if signed:
        w = np.where(rng.random(e) < 0.3, -w, w).astype(np.float32)
    return ei, w


def both_templates(ei, w, n, mode, **kw):
    return (magnetic_template(ei, w, num_nodes=n, mode=mode, device="cpu",
                              **kw),
            jx_magnetic_template(ei, w, num_nodes=n, mode=mode, **kw))


# --- the template ----------------------------------------------------------

VARIANTS = {"unsigned": {}, "signed": dict(signed=True),
            "signed_plain_degree": dict(signed=True, absolute_degree=False)}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mode", ["dense", "segment"])
def test_template_arrays_match_jax(mode, variant):
    n = 120
    ei, w = zipf_graph(n, 700, seed=1, signed=variant != "unsigned")
    t, j = both_templates(ei, w, n, mode, **VARIANTS[variant])
    assert t.mode == j.mode == mode
    e = t.a_norm.shape[0] if mode == "segment" else None
    np.testing.assert_array_equal(t.a_norm.numpy(), np.asarray(j.a_norm)[:e])
    np.testing.assert_array_equal(t.theta.numpy(), np.asarray(j.theta)[:e])
    if mode == "segment":
        np.testing.assert_array_equal(t.row.numpy(), np.asarray(j.row)[:e])
        np.testing.assert_array_equal(t.col.numpy(), np.asarray(j.col)[:e])


def test_auto_mode_follows_the_node_count():
    ei, w = zipf_graph(50, 200, seed=2)
    assert magnetic_template(ei, w, num_nodes=50, device="cpu").mode == \
        "dense"
    big = magnetic_template(ei, w, num_nodes=9000, device="cpu")
    assert big.mode == "mxu" and big.transposed is not None


@pytest.mark.parametrize("q", [0.05, 0.25])
@pytest.mark.parametrize("mode", ["dense", "segment"])
def test_template_propagators_match_jax(mode, q):
    n, f = 120, 6
    ei, w = zipf_graph(n, 700, seed=3)
    t, j = both_templates(ei, w, n, mode)
    rng = np.random.default_rng(3)
    x, g = (rng.standard_normal((n, f)).astype(np.float32) for _ in range(2))

    def jloss(qq):
        P_re, P_im = jx_template_propagators(j, qq)
        return jnp.sum(P_re(x) * g) + jnp.sum(P_im(x) * g)

    qt = torch.tensor(q, requires_grad=True)
    P_re, P_im = template_propagators(t, qt)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    for P, JP in zip((P_re, P_im), jx_template_propagators(j, q)):
        np.testing.assert_allclose(P(xt).detach().numpy(), np.asarray(JP(x)),
                                   **F32_TOL)
    ((P_re(xt) * gt).sum() + (P_im(xt) * gt).sum()).backward()
    np.testing.assert_allclose(qt.grad.item(), float(jax.grad(jloss)(q)),
                               **DQ_TOL)


def test_template_propagators_reject_mxu():
    ei, w = zipf_graph(60, 300, seed=4)
    t = magnetic_template(ei, w, num_nodes=60, mode="mxu", device="cpu")
    with pytest.raises(ValueError, match="template_dual_apply"):
        template_propagators(t, 0.1)


# --- the kernel tier's apply -----------------------------------------------

def apply_both(t, j, q, x, g):
    """Forward, dq and dx of both packages' template_dual_apply."""
    def jf(qq, xx):
        return jnp.sum(jx_template_dual_apply(j, qq, xx) * g)

    jy = jx_template_dual_apply(j, q, jnp.asarray(x))
    jdq, jdx = jax.grad(jf, argnums=(0, 1))(q, jnp.asarray(x))
    qt = torch.tensor(q, requires_grad=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = template_dual_apply(t, qt, xt)
    (y * torch.from_numpy(g)).sum().backward()
    return ((y.detach().numpy(), np.asarray(jy)),
            (qt.grad.item(), float(jdq)),
            (xt.grad.numpy(), np.asarray(jdx)))


@pytest.mark.parametrize("width", [16, 80, 144])
@pytest.mark.parametrize("kind", list(KINDS))
def test_template_dual_apply_matches_jax(kind, width, knobs):
    """Widths: 4F = 32 (one pass, the duplicated gather layout), 160 (one
    pass, two message halves) and 288 (past the 256 lanes: two passes)."""
    knobs(**KINDS[kind])
    n = 512
    ei, w = zipf_graph(n, 6000, seed=23)
    t, j = both_templates(ei, w, n, "mxu")
    for tt, jt in ((t, j), (t.transposed, j.transposed)):
        assert (tt.hot_ids is not None) == ("split" in kind) == \
            (jt.hot_ids is not None)
        assert tt.streamed == ("streamed" in kind) == (jt.stream is not None)
    rng = np.random.default_rng(width)
    x, g = (rng.standard_normal((n, width)).astype(np.float32)
            for _ in range(2))
    y, dq, dx = apply_both(t, j, 0.19, x, g)
    np.testing.assert_allclose(*y, **F32_TOL)
    np.testing.assert_allclose(*dx, **F32_TOL)
    np.testing.assert_allclose(*dq, **DQ_TOL)


@pytest.mark.parametrize("kind", ["flat", "split_streamed"])
def test_template_dual_apply_bf16_messages_match_jax(kind, knobs):
    knobs(**KINDS[kind])
    n = 512
    ei, w = zipf_graph(n, 6000, seed=7)
    t, j = both_templates(ei, w, n, "mxu")
    rng = np.random.default_rng(8)
    x, g = (rng.standard_normal((n, 16)).astype(np.float32)
            for _ in range(2))
    spmm.set_message_dtype("bf16")
    jx_spmm.set_message_dtype("bf16")
    try:
        y, dq, dx = apply_both(t, j, 0.11, x, g)
    finally:
        spmm.set_message_dtype(None)
        jx_spmm.set_message_dtype(None)
    for a, b in (y, dx):
        np.testing.assert_allclose(a, b, **BF16_TOL)
    np.testing.assert_allclose(*dq, **BF16_TOL)


def test_dx_is_skipped_when_x_needs_no_gradient(monkeypatch):
    """The first apply of a model gets data: its backward computes dq and
    no transposed apply."""
    n = 200
    ei, w = zipf_graph(n, 1500, seed=9)
    t = magnetic_template(ei, w, num_nodes=n, mode="mxu", device="cpu")
    calls = []
    real = magnetic_mod._layout_apply
    monkeypatch.setattr(magnetic_mod, "_layout_apply",
                        lambda *a: calls.append(1) or real(*a))
    x = torch.randn(n, 8)
    for need_dx, expected in ((False, 0), (True, 1)):
        calls.clear()
        q = torch.tensor(0.2, requires_grad=True)
        xx = x.clone().requires_grad_(need_dx)
        template_dual_apply(t, q, xx).sum().backward()
        assert len(calls) == expected and q.grad is not None


def test_trainable_dual_matches_jax_and_the_fused_apply():
    """``template_dual`` + ``dual_spmm_stacked_trainable`` (the generic
    per-edge value-cotangent path) against the same in the JAX package,
    and against the fused apply."""
    n = 256
    ei, w = zipf_graph(n, 2000, seed=11)
    t, j = both_templates(ei, w, n, "mxu")
    rng = np.random.default_rng(4)
    x, g = (rng.standard_normal((n, 16)).astype(np.float32)
            for _ in range(2))
    q0 = 0.13

    def jf(qq, xx):
        D = jx_template_dual(j, qq)
        return jnp.sum(jx_spmm.dual_spmm_stacked_trainable(D, xx) * g)

    jdq, jdx = jax.grad(jf, argnums=(0, 1))(q0, x)
    got = []
    for fn in (lambda qq, xx: spmm.dual_spmm_stacked_trainable(
            template_dual(t, qq), xx), lambda qq, xx: template_dual_apply(
            t, qq, xx)):
        q = torch.tensor(q0, requires_grad=True)
        xx = torch.from_numpy(x).requires_grad_(True)
        (fn(q, xx) * torch.from_numpy(g)).sum().backward()
        got.append((q.grad.item(), xx.grad.numpy()))
    for dq, dx in got:
        np.testing.assert_allclose(dq, float(jdq), **DQ_TOL)
        np.testing.assert_allclose(dx, np.asarray(jdx), **F32_TOL)


def test_trainable_dual_rejects_split_layouts(knobs):
    knobs(**SPLIT)
    ei, w = zipf_graph(512, 6000, seed=12)
    t = magnetic_template(ei, w, num_nodes=512, mode="mxu", device="cpu")
    with pytest.raises(ValueError, match="flat layout"):
        spmm.dual_spmm_stacked_trainable(template_dual(t, 0.1),
                                         torch.randn(512, 4))


# --- the model -------------------------------------------------------------

def model_kw(**kw):
    return dict(num_features=2, hidden=8, K=2, label_dim=3, activation=True,
                layer=2, trainable_q=True, **kw)


def jax_grads(jmodel, params, x, y, lap):
    def jloss(p):
        logp = jmodel.apply(p, x, x, lap)
        return -jnp.mean(logp[jnp.arange(len(y)), y]), logp

    (_, logp), grads = jax.value_and_grad(jloss, has_aux=True)(params)
    return np.asarray(logp), state_dict_from_jax(jax.device_get(grads))


def port_grads(model, x, y, lap):
    xt = torch.from_numpy(x)
    logp = model(xt, xt, lap)
    torch.nn.functional.nll_loss(logp, torch.from_numpy(y)).backward()
    return logp.detach().numpy(), {k: p.grad for k, p in
                                   model.named_parameters()}


@pytest.mark.parametrize("kind", ["dense", "segment", "flat",
                                  "split_streamed"])
def test_trainable_q_model_matches_jax(kind, knobs):
    mode = kind if kind in ("dense", "segment") else "mxu"
    knobs(**KINDS.get(kind, {}))
    n = 300
    ei, w = zipf_graph(n, 2500, seed=13)
    t, j = both_templates(ei, w, n, mode)
    rng = np.random.default_rng(13)
    x = rng.random((n, 2)).astype(np.float32)
    y = rng.integers(0, 3, n)
    jmodel = JxMagNetNode(**model_kw(q=0.2))
    params = jmodel.init(jax.random.PRNGKey(0), x, x, j)
    want_logp, want = jax_grads(jmodel, params, x, y, j)
    model = MagNet_node_classification(**model_kw(q=0.2), device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    logp, got = port_grads(model, x, y, t)
    np.testing.assert_allclose(logp, want_logp, **GRAD_TOL)
    assert set(got) == set(want) and "convs.0.q" in got
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **GRAD_TOL)


def test_five_adam_steps_match_jax():
    """From q = 0.25 (the clip's upper bound) with the bench's Adam."""
    n = 300
    ei, w = zipf_graph(n, 2500, seed=17)
    t, j = both_templates(ei, w, n, "mxu")
    rng = np.random.default_rng(17)
    x = rng.random((n, 2)).astype(np.float32)
    y = rng.integers(0, 3, n)
    jmodel = JxMagNetNode(**model_kw(q=0.25))
    params = jmodel.init(jax.random.PRNGKey(1), x, x, j)

    def jloss(p):
        logp = jmodel.apply(p, x, x, j)
        return -jnp.mean(logp[jnp.arange(n), y])

    jt = JxTrainer(jloss, lr=1e-2)
    js = jt.init(params)
    jlosses = [jt.step(js) for _ in range(5)]

    model = MagNet_node_classification(**model_kw(q=0.25), device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    tr = Trainer(lambda m: torch.nn.functional.nll_loss(m(xt, xt, t), yt),
                 lr=1e-2, device="cpu")
    st = tr.init(model)
    losses = [tr.step(st) for _ in range(5)]
    np.testing.assert_allclose(losses, jlosses, **GRAD_TOL)
    want = state_dict_from_jax(jax.device_get(js.params))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k,
                                   **GRAD_TOL)
    assert model.convs[0].q.item() != 0.25


@pytest.mark.parametrize("q0", [0.25, 0.0])
def test_clip_passes_half_the_gradient_at_a_bound(q0):
    """jnp.clip passes half the gradient at either bound of [0, 0.25];
    so must the port (torch.clamp would pass all of it)."""
    n = 150
    ei, w = zipf_graph(n, 1000, seed=19)
    t, j = both_templates(ei, w, n, "mxu")
    rng = np.random.default_rng(19)
    x_re, x_im = (rng.standard_normal((n, 3)).astype(np.float32)
                  for _ in range(2))
    jconv = JxMagNetConv(in_channels=3, out_channels=4, K=2, q=q0,
                         trainable_q=True)
    params = jconv.init(jax.random.PRNGKey(2), x_re, x_im, j)

    def jloss(p):
        o_re, o_im = jconv.apply(p, x_re, x_im, j)
        return jnp.sum(o_re ** 2) + jnp.sum(o_im ** 2)

    want = state_dict_from_jax(jax.device_get(jax.grad(jloss)(params)))
    conv = MagNetConv(3, 4, 2, q=q0, trainable_q=True, device="cpu")
    conv.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    o_re, o_im = conv(torch.from_numpy(x_re), torch.from_numpy(x_im), t)
    ((o_re ** 2).sum() + (o_im ** 2).sum()).backward()
    np.testing.assert_allclose(conv.q.grad.numpy(), want["q"].numpy(),
                               **GRAD_TOL)
    # the clip itself: half of d(clip)/dq at the bound
    q = torch.tensor([q0], requires_grad=True)
    torch.minimum(torch.maximum(q, torch.zeros_like(q)),
                  torch.full_like(q, 0.25)).sum().backward()
    assert q.grad.item() == 0.5
    assert jax.grad(lambda v: jnp.clip(v, 0.0, 0.25))(q0) == 0.5
