"""The port's giant-graph layouts (hot/cold column split, streamed CSR
blocks, the accumulate kernel K2) against the JAX package's (col-split
plans, stream plans, the Pallas K2 in interpret mode on the CPU).

The knobs are lowered on both packages' modules, as the JAX package's own
tests lower them, to values at which both choose the same layout; each
test asserts that layout on both sides.  The one deliberate difference:
the JAX stream threshold counts padded plan edges, the port's counts nnz,
so the thresholds below sit far from both counts.  On the CPU the port's
kernel wrappers run their plain versions; tests/test_torch_cuda.py holds
the kernels against those on the card.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_signed_directed_tpu.nn import (
    MagNet_node_classification as JxMagNetNode)
from pytorch_geometric_signed_directed_tpu.ops import build_coo as jx_build_coo
from pytorch_geometric_signed_directed_tpu.ops import spmm as jx_spmm
from pytorch_geometric_signed_directed_tpu.ops.pallas import scatter_mxu
from pytorch_geometric_signed_directed_tpu.spectral import (
    magnet_propagators as jx_magnet_propagators)

from pytorch_geometric_signed_directed_tpu_torch.convert import (
    state_dict_from_jax)
from pytorch_geometric_signed_directed_tpu_torch.nn import (
    MagNet_node_classification)
from pytorch_geometric_signed_directed_tpu_torch.ops import (
    build_coo, layout, spmm)
from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import scatter_csr
from pytorch_geometric_signed_directed_tpu_torch.spectral import (
    magnet_propagators)

from test_torch_worker_memory import release_memory  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
# f32: the port sums each row in edge order, the TPU kernels in one-hot
# matmul order — the sums agree to rounding, not bit for bit
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 messages: both round every message to bf16 (8 bits of mantissa)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# the MagNet model: Chebyshev recurrences and einsums summed in other orders
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)

SPLIT = dict(COL_SPLIT_MIN_COLS=100, GATHER_FAST_ROWS=64,
             COL_SPLIT_MIN_COVERAGE=0.0)
STREAM = dict(STREAM_THRESHOLD_EDGES=1000, STREAM_BLOCK_EDGES=2048)
KINDS = {"split": SPLIT, "streamed": STREAM,
         "split_streamed": {**SPLIT, **STREAM}}


@pytest.fixture
def knobs(monkeypatch):
    """``knobs(**values)`` sets the same layout knobs on both packages."""
    def set_(**values):
        for k, v in values.items():
            monkeypatch.setattr(layout, k, v)
            monkeypatch.setattr(scatter_mxu, k, v)
    return set_


def skewed(n_rows, n_cols, e, seed):
    """Edges with power-law column degrees, so that a hot set exists."""
    rng = np.random.default_rng(seed)
    col = (rng.zipf(1.3, e) - 1) % n_cols
    row = rng.integers(0, n_rows, e)
    va = rng.standard_normal(e).astype(np.float32)
    vb = rng.standard_normal(e).astype(np.float32)
    return row, col, va, vb


def assert_same_layout(d, j, split, streamed):
    """Port operator ``d`` (a CSR or DualPropagator) and JAX operator
    ``j`` (an MXUCoo or DualPropagator) took the same layout."""
    assert (d.hot_ids is not None) == split == (j.hot_ids is not None)
    assert d.streamed == streamed == (j.stream is not None)
    if split:
        np.testing.assert_array_equal(d.hot_ids.numpy(),
                                      np.asarray(j.hot_ids))
        assert d.hot_blocks > 0
        assert (j.stream.hot_blocks if streamed else j.plan.hot_chunks) > 0
    if streamed:
        assert len(d.blocks) >= 2
    if not split and not streamed:
        assert d.rowptr is not None and not d.blocks


def both_ways(port_fn, jax_fn, x, g):
    """Forward and the backward (the transposed apply) of both."""
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port_fn(xt)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    want, vjp = jax.vjp(jax_fn, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    return ((out.detach().numpy(), np.asarray(want)),
            (dx.numpy(), np.asarray(want_dx)))


def load_script(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- the column split ------------------------------------------------------

@pytest.mark.parametrize("case", ["skewed", "low_coverage", "few_cols"])
def test_col_degree_split_is_bit_equal(case, knobs):
    from pytorch_geometric_signed_directed_tpu_torch.ops import (
        col_degree_split)

    knobs(COL_SPLIT_MIN_COLS=100, GATHER_FAST_ROWS=64)
    rng = np.random.default_rng(3)
    n = 90 if case == "few_cols" else 600
    col = ((rng.zipf(1.3, 5000) - 1) % n if case != "low_coverage"
           else rng.integers(0, n, 5000))
    got = col_degree_split(col, n)
    want = scatter_mxu.col_degree_split(col, n)
    if case == "skewed":
        assert got is not None
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    else:
        assert got is None and want is None


def test_col_split_knobs_are_read_at_call_time(knobs):
    row, col, va, vb = skewed(300, 600, 5000, seed=1)
    assert spmm.dual_propagator(row, col, va, vb, 300, 600, mode="mxu",
                                device="cpu").hot_ids is None
    knobs(**SPLIT)
    assert spmm.dual_propagator(row, col, va, vb, 300, 600, mode="mxu",
                                device="cpu").hot_ids is not None


# --- the dual tier ---------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_dual_layouts_match_jax(kind, dtype, knobs):
    knobs(**KINDS[kind])
    n, e, w = 600, 6000, 24
    row, col, va, vb = skewed(n, n, e, seed=5)
    D = spmm.dual_propagator(row, col, va, vb, n, mode="mxu", device="cpu")
    J = jx_spmm.dual_propagator(row, col, va, vb, n, mode="mxu")
    for d, j in ((D, J), (D.transposed, J.transposed)):
        assert_same_layout(d, j, "split" in kind, "streamed" in kind)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((n, w)).astype(np.float32)
    g = rng.standard_normal((n, w)).astype(np.float32)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    if dtype == "bf16":
        spmm.set_message_dtype("bf16")
        jx_spmm.set_message_dtype("bf16")
    try:
        fwd, bwd = both_ways(lambda v: spmm.dual_spmm_stacked(D, v),
                             lambda v: jx_spmm.dual_spmm_stacked(J, v), x, g)
    finally:
        spmm.set_message_dtype(None)
        jx_spmm.set_message_dtype(None)
    np.testing.assert_allclose(*fwd, **tol)
    np.testing.assert_allclose(*bwd, **tol)


@pytest.mark.parametrize("kind", list(KINDS))
def test_rectangular_single_operator_matches_jax(kind, knobs):
    knobs(**KINDS[kind])
    n_rows, n_cols, e, w = 400, 600, 6000, 8
    row, col, val, _ = skewed(n_rows, n_cols, e, seed=8)
    P = spmm.propagator_from_coo(
        build_coo(row, col, val, n_rows, num_cols=n_cols, device="cpu"),
        mode="mxu")
    J = jx_spmm.propagator_from_coo(
        jx_build_coo(row, col, val, n_rows, num_cols=n_cols), mode="mxu")
    # the transposed operator takes its own split (by row degree) and stream
    for d, j in ((P.csr, J.mxu), (P.csr.transposed, J.mxu.transposed)):
        assert_same_layout(d, j, "split" in kind, "streamed" in kind)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((n_cols, w)).astype(np.float32)
    g = rng.standard_normal((n_rows, w)).astype(np.float32)
    fwd, bwd = both_ways(P, J, x, g)
    np.testing.assert_allclose(*fwd, **F32_TOL)
    np.testing.assert_allclose(*bwd, **F32_TOL)


def test_hub_row_straddles_three_blocks(knobs):
    """A hub row with three blocks' worth of edges is cut at block
    boundaries; K2 sums its pieces in order into one output row."""
    knobs(STREAM_THRESHOLD_EDGES=1000, STREAM_BLOCK_EDGES=1000)
    rng = np.random.default_rng(9)
    n, hub = 400, 77
    row = np.concatenate([np.full(3000, hub), rng.integers(0, n, 3000)])
    col = rng.integers(0, n, 6000)
    val = rng.standard_normal(6000).astype(np.float32)
    P = spmm.make_propagator(row, col, val, n, mode="mxu", device="cpu")
    J = jx_spmm.make_propagator(row, col, val, n, mode="mxu")
    assert_same_layout(P.csr, J.mxu, False, True)
    holding = [b for b in P.csr.blocks
               if b.row0 <= hub < b.row0 + b.rowptr.numel() - 1]
    assert len(holding) >= 3
    assert all(b.e1 - b.e0 <= 1000 for b in P.csr.blocks)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    g = rng.standard_normal((n, 8)).astype(np.float32)
    fwd, bwd = both_ways(P, J, x, g)
    np.testing.assert_allclose(*fwd, **F32_TOL)
    np.testing.assert_allclose(*bwd, **F32_TOL)
    dense = np.zeros((n, n))
    np.add.at(dense, (row, col), val)
    np.testing.assert_allclose(fwd[0], dense @ x, **F32_TOL)


@pytest.mark.parametrize("kind", ["split", "split_streamed"])
def test_empty_cold_section(kind, knobs):
    """Every edge lands in the hot table: the cold section is empty and
    launches nothing."""
    knobs(**KINDS[kind])
    rng = np.random.default_rng(4)
    n, e = 600, 5000
    row = rng.integers(0, n, e)
    col = rng.choice(rng.permutation(n)[:50], e)   # 50 columns < 64 hot
    va, vb = (rng.standard_normal(e).astype(np.float32) for _ in range(2))
    D = spmm.dual_propagator(row, col, va, vb, n, mode="mxu", device="cpu")
    J = jx_spmm.dual_propagator(row, col, va, vb, n, mode="mxu")
    assert_same_layout(D, J, True, "streamed" in kind)
    assert D.hot_blocks == len(D.blocks)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    g = rng.standard_normal((n, 16)).astype(np.float32)
    fwd, bwd = both_ways(lambda v: spmm.dual_spmm_stacked(D, v),
                         lambda v: jx_spmm.dual_spmm_stacked(J, v), x, g)
    np.testing.assert_allclose(*fwd, **F32_TOL)
    np.testing.assert_allclose(*bwd, **F32_TOL)


@pytest.mark.parametrize("kind", ["streamed", "split_streamed"])
def test_stream_blocks_cover_every_edge_once(kind, knobs):
    """Blocks are contiguous, at most STREAM_BLOCK_EDGES edges each, hot
    blocks first, and their local rowptrs name exactly the rows of their
    edges."""
    knobs(**KINDS[kind])
    n, e = 600, 6000
    row, col, va, vb = skewed(n, n, e, seed=11)
    D = spmm.dual_propagator(row, col, va, vb, n, mode="mxu", device="cpu")
    blocks = D.blocks
    assert blocks[0].e0 == 0 and blocks[-1].e1 == e
    assert all(a.e1 == b.e0 for a, b in zip(blocks, blocks[1:]))
    assert all(0 < b.e1 - b.e0 <= STREAM["STREAM_BLOCK_EDGES"]
               for b in blocks)
    # rows named by the blocks, in layout order, against the input edges
    rows = torch.cat([scatter_csr._row_ids(b.rowptr) + b.row0
                      for b in blocks]).numpy()
    assert rows.shape == (e,)
    hot = np.zeros(e, bool)
    if D.hot_ids is not None:
        hot[: D.blocks[D.hot_blocks - 1].e1] = True
        assert 0 < D.hot_blocks < len(D.blocks)
    for section in (hot, ~hot):
        r = rows[section]
        assert np.all(r[1:] >= r[:-1])
    c = D.col.numpy().astype(np.int64)
    if D.hot_ids is not None:
        c[hot] = D.hot_ids.numpy()[c[hot]]
    assert sorted(zip(rows.tolist(), c.tolist())) == \
        sorted(zip(row.tolist(), col.tolist()))


# --- views and the model ---------------------------------------------------

def powerlaw_graph(n, e, seed):
    smoke = load_script("chip_smoke", ROOT / "chip_smoke.py")
    row, col = smoke.powerlaw_digraph(n, e, 1.0, seed=seed)
    return np.vstack([row, col]), np.ones(len(row), np.float32)


@pytest.mark.parametrize("part", ["re", "im"])
def test_views_carry_the_split_and_the_stream(part, knobs):
    """``P_re``/``P_im`` of a split+streamed pair are views over the dual:
    same blocks, hot table and transposed layout, and right values."""
    knobs(**KINDS["split_streamed"])
    n = 600
    ei, w = powerlaw_graph(n, 3000, seed=3)
    lap = magnet_propagators(ei, w, q=0.25, num_nodes=n, mode="mxu",
                             device="cpu")
    ref = magnet_propagators(ei, w, q=0.25, num_nodes=n, mode="segment",
                             device="cpu")
    D = lap.dual
    assert D.hot_ids is not None and D.streamed
    P = getattr(lap, part)
    for v, d in ((P.csr, D), (P.csr.transposed, D.transposed)):
        assert v.hot_ids is d.hot_ids and v.blocks is d.blocks
        assert v.hot_blocks == d.hot_blocks and v.streamed
        assert v.col is d.col
        assert v.val is (d.val_a if part == "re" else d.val_b)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((n, 6)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((n, 6)).astype(np.float32))
    outs = []
    for op in (P, getattr(ref, part)):
        xt = x.clone().requires_grad_(True)
        out = op(xt)
        outs.append((out, torch.autograd.grad(out, xt, g)[0]))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, **F32_TOL)


def test_magnet_on_a_split_streamed_pair_matches_jax(knobs):
    knobs(**KINDS["split_streamed"])
    n = 600
    ei, w = powerlaw_graph(n, 3000, seed=5)
    lap = magnet_propagators(ei, w, q=0.25, num_nodes=n, mode="mxu",
                             device="cpu")
    jlap = jx_magnet_propagators(ei, w, q=0.25, num_nodes=n, mode="mxu")
    for d, j in ((lap.dual, jlap.dual),
                 (lap.dual.transposed, jlap.dual.transposed)):
        assert_same_layout(d, j, True, True)
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
    xt = torch.from_numpy(x)
    logp = model(xt, xt, lap)
    loss = torch.nn.functional.nll_loss(logp, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(logp.detach().numpy(), want, **MODEL_TOL)
    np.testing.assert_allclose(loss.item(), float(jl), **MODEL_TOL)
    want_grads = state_dict_from_jax(jax.device_get(jgrads))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want_grads)
    for k in want_grads:
        np.testing.assert_allclose(got[k].numpy(), want_grads[k].numpy(),
                                   err_msg=k, **MODEL_TOL)


def test_powerlaw_digraph_is_bit_equal_to_the_bench_script():
    smoke = load_script("chip_smoke", ROOT / "chip_smoke.py")
    bench = load_script("bench_giant", ROOT / "scripts" / "bench_giant.py")
    got = smoke.powerlaw_digraph(10_000, 60_000, 1.0, seed=0)
    want = bench.powerlaw_digraph(10_000, 60_000, 1.0, seed=0)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# --- K2's own contract -----------------------------------------------------

@pytest.mark.parametrize("width", [4, 64])
def test_csr_scatter_accum_matches_jax_scatter_accum(width):
    """K2 against the Pallas ``_scatter_accum``: both add the rows' message
    sums into an output that already holds values."""
    rng = np.random.default_rng(width)
    n, e = 300, 2500
    row = rng.integers(0, n // 2, e) * 2          # odd rows without edges
    msgs = rng.standard_normal((e, width)).astype(np.float32)
    plan, perm = scatter_mxu.build_scatter_plan(row, n)
    (msgs_plan,) = scatter_mxu.permute_edge_data(perm, msgs)
    out0 = rng.standard_normal((plan.num_windows * plan.window,
                                width)).astype(np.float32)
    want = scatter_mxu._scatter_accum(
        plan.win, plan.local_rows, jnp.asarray(msgs_plan),
        jnp.asarray(out0), window=plan.window, interpret=True,
        precision=jax.lax.Precision.HIGHEST)
    order = np.argsort(row, kind="stable")
    rowptr = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(np.bincount(row, minlength=n))]).astype(np.int32))
    out = torch.from_numpy(out0[:n].copy())
    got = scatter_csr.csr_scatter_accum(rowptr, torch.from_numpy(msgs[order]),
                                        out)
    assert got is out                              # in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:n], **F32_TOL)
    np.testing.assert_array_equal(got.numpy()[1::2], out0[:n][1::2])


def test_csr_dual_spmm_accum_on_a_block_with_a_row_offset():
    """A block's local rowptr over rows [row0, row0 + rows): only those
    rows change, each by its edges' messages."""
    rng = np.random.default_rng(1)
    rows, row0, n_out, m, e, w = 50, 30, 120, 80, 700, 6
    local = np.sort(rng.integers(0, rows, e))
    col = rng.integers(0, m, e)
    va, vb = (rng.standard_normal(e).astype(np.float32) for _ in range(2))
    x = rng.standard_normal((m, w)).astype(np.float32)
    out0 = rng.standard_normal((n_out, w)).astype(np.float32)
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(local,
                                                        minlength=rows))])
    got = scatter_csr.csr_dual_spmm_accum(
        torch.from_numpy(rowptr.astype(np.int32)),
        torch.from_numpy(col.astype(np.int32)), torch.from_numpy(va),
        torch.from_numpy(vb), torch.from_numpy(x), w // 2,
        torch.from_numpy(out0.copy()), row0)
    want = out0.astype(np.float64)
    sel = np.where(np.arange(w)[None, :] < w // 2, va[:, None], vb[:, None])
    np.add.at(want, local + row0, (sel * x[col]).astype(np.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    untouched = np.ones(n_out, bool)
    untouched[np.unique(local) + row0] = False
    np.testing.assert_array_equal(got.numpy()[untouched], out0[untouched])
