"""The attention substrate in the port vs the JAX package: the segment
ops (sum, mean, max, softmax), K1's segment sum with a gradient
(``ops.scatter.scatter_sum``), ``build_attention_graph`` and the softmax
aggregates on both paths ("mxu": K1, against JAX's Pallas scatter plan in
interpret mode; "segment": against JAX's "xla" backend).  Same numpy
inputs from a seed, values and gradients at 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_signed_directed_tpu.nn.signed import (
    snea_conv as jx_snea_conv)
from pytorch_geometric_signed_directed_tpu.ops import segment as jx_segment

from pytorch_geometric_signed_directed_tpu_torch.nn.signed import snea_conv
from pytorch_geometric_signed_directed_tpu_torch.ops import (
    build_scatter_plan, scatter_sum, segment_max, segment_mean,
    segment_softmax, segment_sum)
from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import scatter_csr

OPS_TOL = dict(rtol=1e-5, atol=1e-5)


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# --- segment ops -------------------------------------------------------------

def segment_case(seed, e=300, n=40, f=5, padding=True):
    """Ids in [0, n) with some segments left empty, plus padding ids
    (>= n) when asked."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, e)
    ids[np.isin(ids, [0, 7, n - 1])] = 3            # segments 0, 7, n-1 empty
    if padding:
        ids[rng.random(e) < 0.1] = n + rng.integers(0, 3)
    data = rng.standard_normal((e, f)).astype(np.float32) * 3
    return ids, data, n


@pytest.mark.parametrize("padding", [False, True])
@pytest.mark.parametrize("name", ["segment_sum", "segment_mean",
                                  "segment_max"])
def test_segment_reductions_match_jax(name, padding):
    ids, data, n = segment_case(1, padding=padding)
    port = {"segment_sum": segment_sum, "segment_mean": segment_mean,
            "segment_max": segment_max}[name]
    want = getattr(jx_segment, name)(jnp.asarray(data), jnp.asarray(ids), n)
    got = port(t(data), torch.from_numpy(ids), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OPS_TOL)
    if name == "segment_max":
        assert np.isneginf(got.numpy()[[0, 7, n - 1]]).all()


@pytest.mark.parametrize("padding", [False, True])
@pytest.mark.parametrize("name", ["segment_sum", "segment_mean",
                                  "segment_max"])
def test_segment_reduction_gradients_match_jax(name, padding):
    ids, data, n = segment_case(2, padding=padding)
    rng = np.random.default_rng(3)
    g = rng.standard_normal((n, data.shape[1])).astype(np.float32)
    port = {"segment_sum": segment_sum, "segment_mean": segment_mean,
            "segment_max": segment_max}[name]

    def jloss(d):
        out = getattr(jx_segment, name)(d, jnp.asarray(ids), n)
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0) * g)

    want = jax.grad(jloss)(jnp.asarray(data))
    d = t(data).requires_grad_(True)
    out = port(d, torch.from_numpy(ids), n)
    (torch.where(torch.isfinite(out), out, 0.0) * t(g)).sum().backward()
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(want), **OPS_TOL)


@pytest.mark.parametrize("scale", [1.0, 50.0])
@pytest.mark.parametrize("padding", [False, True])
def test_segment_softmax_matches_jax(padding, scale):
    ids, data, n = segment_case(4, padding=padding)
    logits = data[:, 0] * scale
    g = np.random.default_rng(5).standard_normal(len(ids)).astype(np.float32)

    def jloss(lg):
        a = jx_segment.segment_softmax(lg, jnp.asarray(ids), n)
        return jnp.sum(a * g), a

    (_, want), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits))
    lg = t(logits).requires_grad_(True)
    got = segment_softmax(lg, torch.from_numpy(ids), n)
    (got * t(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **OPS_TOL)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(jg), **OPS_TOL)
    # each non-empty segment sums to 1; padding ids weigh 0
    valid = ids < n
    sums = np.bincount(ids[valid], got.detach().numpy()[valid], minlength=n)
    np.testing.assert_allclose(sums[np.bincount(ids[valid],
                                                minlength=n) > 0], 1.0,
                               rtol=1e-5)
    assert (got.detach().numpy()[~valid] == 0).all()


def test_segment_softmax_of_empty_input():
    out = segment_softmax(torch.zeros(0), torch.zeros(0, dtype=torch.long), 4)
    assert out.shape == (0,)


# --- K1 with a gradient ------------------------------------------------------

def sorted_rows(seed, e=200, n=30):
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(0, n, e))
    rows = rows[(rows != 4) & (rows != n - 1)]         # two empty rows
    return rows, n


def test_scatter_sum_gradcheck_float64():
    rows, n = sorted_rows(0, e=60, n=12)
    plan = build_scatter_plan(rows, n, device="cpu")
    msgs = torch.randn(len(rows), 3, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(0),
                       requires_grad=True)
    assert torch.autograd.gradcheck(lambda m: scatter_sum(plan, m), (msgs,))


@pytest.mark.parametrize("width", [1, 17, 21, 34])
def test_scatter_sum_matches_index_add_and_its_gradient(width):
    rows, n = sorted_rows(1)
    plan = build_scatter_plan(rows, n, device="cpu")
    rng = np.random.default_rng(width)
    msgs = t(rng.standard_normal((len(rows), width))).requires_grad_(True)
    g = t(rng.standard_normal((n, width)))
    out = scatter_sum(plan, msgs)
    want = torch.zeros(n, width, dtype=torch.float64).index_add_(
        0, torch.from_numpy(rows), msgs.detach().double())
    np.testing.assert_allclose(out.detach().numpy(), want.numpy(), **OPS_TOL)
    assert (out.detach()[[4, n - 1]] == 0).all()
    (out * g).sum().backward()
    np.testing.assert_array_equal(msgs.grad.numpy(),
                                  g.numpy()[rows])


def test_scatter_plan_holds_the_rowptr_and_its_split():
    rows, n = sorted_rows(2)
    plan = build_scatter_plan(rows, n, device="cpu")
    assert plan.rowptr.dtype == torch.int32 and plan.num_rows == n
    np.testing.assert_array_equal(
        np.diff(plan.rowptr.numpy()), np.bincount(rows, minlength=n))
    np.testing.assert_array_equal(plan.row_ids.numpy(), rows)
    assert plan.split.rows.numel() == 0                 # no row is long
    long_rows = np.repeat([0, 3], [scatter_csr.PIECE_EDGES + 5, 2])
    assert build_scatter_plan(long_rows, 5,
                              device="cpu").split.rows.tolist() == [0]
    with pytest.raises(ValueError, match="sorted"):
        build_scatter_plan(rows[::-1], n, device="cpu")
    with pytest.raises(ValueError, match="sorted"):
        build_scatter_plan(np.array([0, n]), n, device="cpu")


def test_plain_scatter_sum_keeps_float32_for_float32_messages():
    rows, n = sorted_rows(3)
    plan = build_scatter_plan(rows, n, device="cpu")
    assert scatter_sum(plan, torch.ones(len(rows), 2)).dtype == torch.float32
    assert scatter_sum(plan, torch.ones(len(rows), 2,
                                        dtype=torch.bfloat16)).dtype == \
        torch.float32


# --- build_attention_graph ---------------------------------------------------

def edge_sets(seed=0, n=25):
    """A set with self-edges and duplicates, and a second, flagged set."""
    rng = np.random.default_rng(seed)
    a = np.vstack([rng.integers(0, n, 80), rng.integers(0, n, 80)])
    a[:, :5] = [[1, 2, 3, 3, 3], [1, 2, 4, 4, 4]]      # 2 self, 3 duplicates
    b = np.vstack([rng.integers(0, n, 30), rng.integers(0, n, 30)])
    return a, b, n


def edge_multiset(src, dst, flag):
    return sorted(zip(src.tolist(), dst.tolist(), flag.tolist()))


@pytest.mark.parametrize("loops", [(True, False), (False, True),
                                   (True, True), (False, False)])
def test_build_attention_graph_matches_jax(loops):
    a, b, n = edge_sets()
    sets = [(a, 0, loops[0]), (b, 1, loops[1])]
    g = snea_conv.build_attention_graph(sets, n, device="cpu")
    jg = jx_snea_conv.build_attention_graph(sets, n)
    valid = np.asarray(jg.dst) < n
    assert edge_multiset(g.src.numpy(), g.dst.numpy(), g.edge_p.numpy()) == \
        edge_multiset(np.asarray(jg.src)[valid], np.asarray(jg.dst)[valid],
                      np.asarray(jg.edge_p)[valid])
    # the expected edges: self-edges dropped, duplicates kept, loops added
    want = []
    for ei, flag, lp in sets:
        keep = ei[0] != ei[1]
        want += [(s, d, flag) for s, d in zip(ei[0][keep], ei[1][keep])]
        want += [(i, i, flag) for i in range(n)] if lp else []
    assert edge_multiset(g.src.numpy(), g.dst.numpy(), g.edge_p.numpy()) == \
        sorted((int(s), int(d), f) for s, d, f in want)
    assert (np.diff(g.dst.numpy()) >= 0).all()
    np.testing.assert_array_equal(
        np.diff(g.rowptr.numpy()), np.bincount(g.dst.numpy(), minlength=n))
    assert g.row_ids is g.dst and g.split is g.plan.split


def test_build_attention_graph_takes_empty_sets():
    g = snea_conv.build_attention_graph(
        [(np.zeros((2, 0), np.int64), 0, False)], 6, device="cpu")
    assert g.src.numel() == 0 and g.rowptr.tolist() == [0] * 7
    x = torch.randn(6, 3)
    out = snea_conv.attention_softmax_aggregate(g, torch.zeros(0),
                                                x[g.src])
    assert out.shape == (6, 3) and (out == 0).all()


# --- the aggregates ----------------------------------------------------------

def aggregate_case(seed=0, n=25, f=4, scale=1.0):
    a, b, n = edge_sets(seed, n)
    sets = [(a, 0, True), (b, 1, False)]
    rng = np.random.default_rng(seed + 10)
    x = rng.standard_normal((n, f)).astype(np.float32)
    return sets, n, x, scale


def _edge_inputs(src, dst, x, scale, xp, steps=False):
    """Per-edge logits and messages from node features (so that both
    packages see the same values whatever their edge order).  ``steps``:
    logits of +-scale, one sign a destination row."""
    if steps:
        l1, l2 = scale * xp.sign(x[dst, 0]), scale * xp.sign(x[dst, 1])
    else:
        l1 = scale * xp.tanh(x[src, 0] * 2.0 - x[dst, 1])
        l2 = scale * xp.tanh(x[dst, 2] + 0.5 * x[src, 3])
    return l1, x[src], l2, x[dst]


def jx_aggregate(sets, n, x, scale, pair, backend, monkeypatch, g_out,
                 steps=False):
    monkeypatch.setattr(jx_snea_conv, "AGGREGATE_BACKEND", backend)
    jg = jx_snea_conv.build_attention_graph(sets, n)
    src = jnp.minimum(jg.src, n - 1)
    dst = jnp.minimum(jg.dst, n - 1)

    def f(xx):
        l1, m1, l2, m2 = _edge_inputs(src, dst, xx, scale, jnp, steps)
        if pair:
            o = jnp.concatenate(jx_snea_conv.attention_softmax_aggregate_pair(
                jg, l1, m1, l2, m2), axis=1)
        else:
            o = jx_snea_conv.attention_softmax_aggregate(jg, l1, m1)
        return jnp.sum(o * g_out), o

    (_, out), grad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    return np.asarray(out), np.asarray(grad)


@pytest.mark.parametrize("scale", [1.0, 8.0])
@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("aggregate,backend", [("mxu", "mxu"),
                                               ("segment", "xla")])
def test_aggregates_match_jax(aggregate, backend, pair, scale, monkeypatch):
    sets, n, x, scale = aggregate_case(scale=scale)
    f = x.shape[1]
    g_out = np.random.default_rng(7).standard_normal(
        (n, 2 * f if pair else f)).astype(np.float32)
    want, jgrad = jx_aggregate(sets, n, x, scale, pair, backend, monkeypatch,
                               g_out)
    g = snea_conv.build_attention_graph(sets, n, device="cpu")
    xt = t(x).requires_grad_(True)
    l1, m1, l2, m2 = _edge_inputs(g.src, g.dst, xt, scale, torch)
    if pair:
        out = torch.cat(snea_conv.attention_softmax_aggregate_pair(
            g, l1, m1, l2, m2, aggregate), 1)
    else:
        out = snea_conv.attention_softmax_aggregate(g, l1, m1, aggregate)
    (out * t(g_out)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, **OPS_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), jgrad, **OPS_TOL)


@pytest.mark.parametrize("pair", [False, True])
def test_the_global_shift_underflows_as_in_jax(pair, monkeypatch):
    """Logits 120 apart: the one global shift underflows exp() to 0 on
    whole rows, which then aggregate to 0 in both packages (the
    reference's behaviour, kept).  Values only: JAX's gradient of such a
    row is NaN (its division rule squares the floored denominator), the
    port's finite."""
    sets, n, x, scale = aggregate_case(seed=5, scale=60.0)
    f = x.shape[1]
    g_out = np.ones((n, 2 * f if pair else f), np.float32)
    want, _ = jx_aggregate(sets, n, x, scale, pair, "mxu", monkeypatch,
                           g_out, steps=True)
    g = snea_conv.build_attention_graph(sets, n, device="cpu")
    l1, m1, l2, m2 = _edge_inputs(g.src, g.dst, t(x), scale, torch, True)
    if pair:
        out = torch.cat(snea_conv.attention_softmax_aggregate_pair(
            g, l1, m1, l2, m2), 1)
    else:
        out = snea_conv.attention_softmax_aggregate(g, l1, m1)
    np.testing.assert_allclose(out.numpy(), want, **OPS_TOL)
    assert (want == 0).all(axis=1).any()            # some rows underflow


@pytest.mark.parametrize("pair", [False, True])
def test_the_two_aggregates_agree(pair):
    sets, n, x, scale = aggregate_case(seed=3)
    g = snea_conv.build_attention_graph(sets, n, device="cpu")
    outs = []
    for aggregate in snea_conv.AGGREGATES:
        l1, m1, l2, m2 = _edge_inputs(g.src, g.dst, t(x), scale, torch)
        if pair:
            outs.append(torch.cat(snea_conv.attention_softmax_aggregate_pair(
                g, l1, m1, l2, m2, aggregate), 1))
        else:
            outs.append(snea_conv.attention_softmax_aggregate(g, l1, m1,
                                                              aggregate))
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), **OPS_TOL)


def test_an_unknown_aggregate_raises():
    sets, n, x, _ = aggregate_case()
    g = snea_conv.build_attention_graph(sets, n, device="cpu")
    with pytest.raises(ValueError, match="aggregate"):
        snea_conv.attention_softmax_aggregate(g, torch.zeros(g.src.numel()),
                                              t(x)[g.src], "xla")
