"""The fused scatter + SDDMM (the port of the TPU kernels K3 and K4)
against the JAX package's, on the CPU.

The port's entries (ops/sddmm.py) take a template's transposed layout and
gather the cotangent themselves; the JAX entries take the same template's
plan and the gathered cotangent, and run their Pallas kernels in interpret
mode.  On the CPU the port's wrappers run their plain versions (float64
sums); tests/test_torch_cuda.py holds the kernels against those on the
card.  Layout knobs are lowered on both packages' modules, as in
tests/test_torch_layouts.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_signed_directed_tpu.ops.pallas import scatter_mxu
from pytorch_geometric_signed_directed_tpu.parallel.mxu_shard import (
    _template_terms as jx_terms)
from pytorch_geometric_signed_directed_tpu.spectral import (
    magnetic_template as jx_magnetic_template)

from pytorch_geometric_signed_directed_tpu_torch.instrument import reset_counts
from pytorch_geometric_signed_directed_tpu_torch.ops import layout, sddmm
from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import dual_sddmm
from pytorch_geometric_signed_directed_tpu_torch.parallel.mxu_shard import (
    _template_terms)
from pytorch_geometric_signed_directed_tpu_torch.spectral import (
    magnetic_template)

from test_torch_worker_memory import release_memory  # noqa: F401

# f32: row sums in edge order (float64 here) against one-hot matmuls
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 cotangents: both round the apply's messages to bf16; the TPU kernel
# also rounds the dq products, the port keeps them in f32
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# acc sums every row's dq products: larger terms cancel
ACC_TOL = dict(rtol=1e-4, atol=1e-4)

SPLIT = dict(COL_SPLIT_MIN_COLS=100, GATHER_FAST_ROWS=64,
             COL_SPLIT_MIN_COVERAGE=0.0)
STREAM = dict(STREAM_THRESHOLD_EDGES=1000, STREAM_BLOCK_EDGES=2048)
Q = 0.19


@pytest.fixture
def knobs(monkeypatch):
    def set_(**values):
        for k, v in values.items():
            monkeypatch.setattr(layout, k, v)
            monkeypatch.setattr(scatter_mxu, k, v)
    return set_


def zipf_graph(n, e, seed):
    """A digraph with power-law column degrees, so that a hot set exists."""
    rng = np.random.default_rng(seed)
    ei = np.vstack([rng.integers(0, n, e), (rng.zipf(1.3, e) - 1) % n])
    return ei, rng.random(e).astype(np.float32)


def both_transposed(n, e, seed):
    ei, w = zipf_graph(n, e, seed)
    t = magnetic_template(ei, w, num_nodes=n, mode="mxu", device="cpu")
    j = jx_magnetic_template(ei, w, num_nodes=n, mode="mxu")
    return t.transposed, j.transposed


def port_terms(tt):
    return _template_terms(tt.a_norm, tt.theta, torch.tensor(Q))


def jax_terms(a, th):
    return jx_terms(jnp.asarray(a), jnp.asarray(th), jnp.float32(Q))


def tables(n, w, seed, dtype):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, w)).astype(np.float32)
    x = rng.standard_normal((n, w)).astype(np.float32)
    jg = jnp.asarray(g).astype(jnp.bfloat16 if dtype == "bf16" else
                              jnp.float32)
    tg = torch.from_numpy(g).to(torch.bfloat16 if dtype == "bf16" else
                                torch.float32)
    return tg, torch.from_numpy(x), jg, jnp.asarray(x)


def assert_match(got, want, dtype):
    out, acc = got
    want_acc = np.asarray(want[1])
    np.testing.assert_allclose(out.numpy(), np.asarray(want[0]),
                               **(F32_TOL if dtype == "f32" else BF16_TOL))
    if dtype == "f32":
        np.testing.assert_allclose(acc.numpy(), want_acc, **ACC_TOL)
        return
    # the TPU kernel's bf16 rounding of every dq product (2^-9 of the
    # term) adds up over the terms of a lane, so a lane whose terms cancel
    # is held at BF16_TOL of the largest lane, and dq (the sum) at BF16_TOL
    np.testing.assert_allclose(acc.numpy(), want_acc, rtol=2e-2,
                               atol=2e-2 * np.abs(want_acc).max())
    np.testing.assert_allclose(float(acc.sum()), float(want_acc.sum()),
                               **BF16_TOL)


# --- K3: the flat layout ---------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width", [4, 16])
def test_dual_scatter_sddmm_matches_jax(width, dtype):
    n = 300
    tt, jt = both_transposed(n, 2500, seed=width)
    assert tt.rowptr is not None and jt.plan is not None
    g, x, jg, jx = tables(n, width, 1, dtype)
    got = sddmm.dual_scatter_sddmm(tt, g, *port_terms(tt), x, width // 2)
    want = scatter_mxu.dual_scatter_sddmm(
        jt.plan, jg[jt.col], *jax_terms(jt.a_norm, jt.theta), jx,
        width // 2)
    assert_match(got, want, dtype)


def test_csr_dual_sddmm_plain_against_numpy():
    """Duplicate edges and rows without edges, against float64 numpy."""
    rng = np.random.default_rng(3)
    n, m, e, w = 120, 90, 1500, 6
    row = np.sort(rng.integers(0, n // 2, e) * 2)     # odd rows empty
    col = rng.integers(0, m, e)
    col[:100] = col[-100:]
    va, vb, wa, wb = (rng.standard_normal(e).astype(np.float32)
                      for _ in range(4))
    g = rng.standard_normal((m, w)).astype(np.float32)
    x = rng.standard_normal((n, w)).astype(np.float32)
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(row, minlength=n))])
    T = torch.from_numpy
    out, acc = dual_sddmm.csr_dual_sddmm(
        T(rowptr.astype(np.int32)), T(col.astype(np.int32)), T(va), T(vb),
        T(wa), T(wb), T(g), T(x), w // 2)
    lo = np.arange(w)[None, :] < w // 2
    v = np.where(lo, va[:, None], vb[:, None]) * g[col]
    d = np.where(lo, wa[:, None], wb[:, None]) * g[col]
    want_out = np.zeros((n, w))
    want_m = np.zeros((n, w))
    np.add.at(want_out, row, v.astype(np.float32))
    np.add.at(want_m, row, d.astype(np.float32))
    np.testing.assert_allclose(out.numpy(), want_out, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(out.numpy()[1::2], 0)
    np.testing.assert_allclose(acc.numpy(), (x * want_m).sum(0), rtol=1e-6,
                               atol=1e-6)


# --- K4: the accumulate mode -----------------------------------------------

def test_csr_dual_sddmm_accum_adds_in_place_at_a_row_offset():
    rng = np.random.default_rng(4)
    rows, row0, n_out, m, e, w = 40, 25, 100, 70, 600, 8
    local = np.sort(rng.integers(0, rows, e))
    col = rng.integers(0, m, e)
    va, vb, wa, wb = (rng.standard_normal(e).astype(np.float32)
                      for _ in range(4))
    g = rng.standard_normal((m, w)).astype(np.float32)
    x = rng.standard_normal((n_out, w)).astype(np.float32)
    out0 = rng.standard_normal((n_out, w)).astype(np.float32)
    acc0 = rng.standard_normal(w).astype(np.float32)
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(local,
                                                        minlength=rows))])
    T = torch.from_numpy
    out, acc = T(out0.copy()), T(acc0.copy())
    args = (T(rowptr.astype(np.int32)), T(col.astype(np.int32)), T(va),
            T(vb), T(wa), T(wb), T(g), T(x), w // 2)
    plain = dual_sddmm.csr_dual_sddmm_accum_plain(*args, out, acc, row0)
    got = dual_sddmm.csr_dual_sddmm_accum(*args, out, acc, row0)
    assert got[0] is out and got[1] is acc                # in place
    lo = np.arange(w)[None, :] < w // 2
    want_out = out0.astype(np.float64)
    want_m = np.zeros((n_out, w))
    np.add.at(want_out, local + row0,
              (np.where(lo, va[:, None], vb[:, None]) * g[col])
              .astype(np.float32))
    np.add.at(want_m, local + row0,
              (np.where(lo, wa[:, None], wb[:, None]) * g[col])
              .astype(np.float32))
    for o, a in (got, plain):
        np.testing.assert_allclose(o.numpy(), want_out, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(a.numpy(), acc0 + (x * want_m).sum(0),
                                   rtol=1e-6, atol=1e-6)
    untouched = np.ones(n_out, bool)
    untouched[np.unique(local) + row0] = False
    np.testing.assert_array_equal(got[0].numpy()[untouched],
                                  out0[untouched])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_split_dual_scatter_sddmm_matches_jax(dtype, knobs):
    knobs(**SPLIT)
    n, w = 512, 16
    tt, jt = both_transposed(n, 6000, seed=23)
    assert tt.hot_ids is not None and not tt.streamed
    assert jt.hot_ids is not None and jt.plan.hot_chunks > 0
    np.testing.assert_array_equal(tt.hot_ids.numpy(), np.asarray(jt.hot_ids))
    g, x, jg, jx = tables(n, w, 2, dtype)
    got = sddmm.split_dual_scatter_sddmm(tt, g, *port_terms(tt), x, w // 2)
    chunk = (jt.plan.local_rows.shape[0] // jt.plan.win.shape[0]) \
        * scatter_mxu.SUB
    he = jt.plan.hot_chunks * chunk
    want = scatter_mxu.split_dual_scatter_sddmm(
        jt.plan, jg[jt.hot_ids][jt.col[:he]], jg[jt.col[he:]],
        *jax_terms(jt.a_norm, jt.theta), jx, w // 2)
    assert_match(got, want, dtype)


@pytest.mark.parametrize("split", [False, True])
def test_streamed_dual_scatter_sddmm_matches_jax(split, knobs):
    knobs(**STREAM, **(SPLIT if split else {}))
    n, w = 512, 16
    tt, jt = both_transposed(n, 6000, seed=29)
    assert tt.streamed and len(tt.blocks) >= 2 and jt.stream is not None
    assert (tt.hot_ids is not None) == split == (jt.hot_ids is not None)
    g, x, jg, jx = tables(n, w, 3, "f32")
    got = sddmm.streamed_dual_scatter_sddmm(tt, g, *port_terms(tt), x,
                                            w // 2)

    def make_terms(ge, i):
        return (ge, *jax_terms(jt.a_norm[i], jt.theta[i]))

    want = scatter_mxu.streamed_dual_scatter_sddmm(
        jt.stream, jt.col, make_terms, jg, jx, w // 2,
        g_hot=jg[jt.hot_ids] if split else None)
    assert_match(got, want, "f32")


def test_layouts_agree_with_the_flat_entry(knobs):
    """The split and streamed entries give the flat entry's result."""
    n, w = 512, 8
    ei, wt = zipf_graph(n, 6000, seed=31)
    flat = magnetic_template(ei, wt, num_nodes=n, mode="mxu",
                             device="cpu").transposed
    g, x, _, _ = tables(n, w, 4, "f32")
    want = sddmm.dual_scatter_sddmm(flat, g, *port_terms(flat), x, w // 2)
    knobs(**SPLIT, **STREAM)
    tt = magnetic_template(ei, wt, num_nodes=n, mode="mxu",
                           device="cpu").transposed
    got = sddmm.streamed_dual_scatter_sddmm(tt, g, *port_terms(tt), x,
                                            w // 2)
    torch.testing.assert_close(got[0], want[0], **F32_TOL)
    torch.testing.assert_close(got[1], want[1], **ACC_TOL)


def test_entries_reject_the_wrong_layout(knobs):
    n = 300
    ei, wt = zipf_graph(n, 2500, seed=5)
    flat = magnetic_template(ei, wt, num_nodes=n, mode="mxu",
                             device="cpu").transposed
    g, x, _, _ = tables(n, 4, 5, "f32")
    terms = port_terms(flat)
    with pytest.raises(ValueError, match="split"):
        sddmm.split_dual_scatter_sddmm(flat, g, *terms, x, 2)
    with pytest.raises(ValueError, match="streamed"):
        sddmm.streamed_dual_scatter_sddmm(flat, g, *terms, x, 2)
    knobs(**STREAM)
    streamed = magnetic_template(ei, wt, num_nodes=n, mode="mxu",
                                 device="cpu").transposed
    with pytest.raises(ValueError, match="flat"):
        sddmm.dual_scatter_sddmm(streamed, g, *port_terms(streamed), x, 2)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    reset_counts()
    n = 200
    tt, _ = both_transposed(n, 1500, seed=6)
    g, x, _, _ = tables(n, 4, 6, "f32")
    sddmm.dual_scatter_sddmm(tt, g, *port_terms(tt), x, 2)
    assert dual_sddmm.LAUNCHES == {"csr_dual_sddmm": 0,
                                   "csr_dual_sddmm_accum": 0}
