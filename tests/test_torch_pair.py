"""The trainable-q pair forward on K1's ``csr_pair_spmm``, K3's cut hub
rows and ``csr_scatter_sum``'s fold order, on the CPU.

The kernels run only on the card (tests/test_torch_cuda.py).  Here the
plain versions are held against float64 numpy; float64 emulations of what
the kernels do (pieces of cut rows, their partials and dq terms, the
strided edge slots of a message row and their butterfly fold) against the
plain versions and the JAX package's Pallas kernels in interpret mode; the
pair walk's float32 summation order on a hub row against float64; and
the port's ``_template_pair_forward`` against the JAX package's on flat,
split and streamed templates (layout knobs lowered on both packages'
modules, as in tests/test_torch_layouts.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_signed_directed_tpu.ops import spmm as jx_spmm
from pytorch_geometric_signed_directed_tpu.ops.pallas import scatter_mxu
from pytorch_geometric_signed_directed_tpu.spectral import (
    magnetic as jx_magnetic, magnetic_template as jx_magnetic_template)

from pytorch_geometric_signed_directed_tpu_torch.ops import layout, spmm
from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
    dual_sddmm, scatter_csr)
from pytorch_geometric_signed_directed_tpu_torch.spectral import (
    magnetic as magnetic_mod, magnetic_template)

from test_torch_worker_memory import release_memory  # noqa: F401

# float64 sums in another order, each rounded once to float32
EMU_TOL = dict(rtol=1e-6, atol=1e-6)
# against the TPU kernels: one-hot matmul order at HIGHEST
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 messages: both round every message to bf16, in other places
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# acc sums every row's dq products: larger terms cancel
ACC_TOL = dict(rtol=1e-4, atol=1e-4)

SPLIT = dict(COL_SPLIT_MIN_COLS=100, GATHER_FAST_ROWS=64,
             COL_SPLIT_MIN_COVERAGE=0.0)
STREAM = dict(STREAM_THRESHOLD_EDGES=1000, STREAM_BLOCK_EDGES=2048)
KINDS = {"flat": {}, "split": SPLIT, "streamed": STREAM}


@pytest.fixture
def knobs(monkeypatch):
    def set_(**values):
        for k, v in values.items():
            monkeypatch.setattr(layout, k, v)
            monkeypatch.setattr(scatter_mxu, k, v)
    return set_


def rowptr_of(lengths):
    return torch.from_numpy(np.concatenate(
        [[0], np.cumsum(lengths)]).astype(np.int32))


def cut_case(seed, piece_len, width, m=40, n_vals=4):
    """Rows one edge shorter than, as long as and one edge longer than a
    piece, a long row, empty rows and short ones; duplicate edges (the
    first and last few share their columns); per-edge values and an x."""
    rng = np.random.default_rng(seed)
    lengths = np.array([max(piece_len - 1, 0), piece_len, piece_len + 1, 0,
                        7 * piece_len + 3, 2, 0, 1, 5], np.int64)
    e = int(lengths.sum())
    col = rng.integers(0, m, e)
    col[:4] = col[-4:]
    vals = [torch.from_numpy(rng.standard_normal(e).astype(np.float32))
            for _ in range(n_vals)]
    x = torch.from_numpy(rng.standard_normal((m, width)).astype(np.float32))
    return (rowptr_of(lengths), lengths,
            torch.from_numpy(col.astype(np.int32)), vals, x)


def numpy_pair(lengths, col, vals, x, fa, dtype):
    """float64 row sums of the pair's two rounded products."""
    va, vb, wa, wb = (v.numpy() for v in vals)
    xs = x.to(dtype).float().numpy()
    lo = np.arange(xs.shape[1])[None, :] < fa
    row = np.repeat(np.arange(len(lengths)), lengths)
    out = np.zeros((len(lengths), 2 * xs.shape[1]))
    for half, (a, b) in enumerate(((va, vb), (wa, wb))):
        m = np.where(lo, a[:, None], b[:, None]) * xs[col.numpy()]
        m = torch.from_numpy(m.astype(np.float32)).to(dtype).double().numpy()
        np.add.at(out[:, half * xs.shape[1]:(half + 1) * xs.shape[1]], row, m)
    return out


# --- csr_pair_spmm: the plain versions -------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("piece_len", [3, 8])
def test_pair_plain_matches_numpy(piece_len, dtype):
    mdt = torch.float32 if dtype == "f32" else torch.bfloat16
    rowptr, lengths, col, vals, x = cut_case(piece_len, piece_len, 6)
    got = scatter_csr.csr_pair_spmm(rowptr, col, *vals, x.to(mdt), 3)
    assert got.shape == (len(lengths), 12) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               numpy_pair(lengths, col, vals, x, 3, mdt),
                               rtol=1e-6, atol=1e-6)
    assert torch.all(got[torch.from_numpy(lengths == 0)] == 0)


def test_pair_accum_adds_at_a_row_offset_and_leaves_empty_rows_alone():
    rowptr, lengths, col, vals, x = cut_case(2, 4, 6)
    n, row0 = len(lengths), 3
    out0 = torch.randn(n + 5, 12, generator=torch.Generator().manual_seed(0))
    out = out0.clone()
    plain = scatter_csr.csr_pair_spmm_accum_plain(rowptr, col, *vals, x, 3,
                                                  out0, row0)
    got = scatter_csr.csr_pair_spmm_accum(rowptr, col, *vals, x, 3, out,
                                          row0)
    assert got is out                                     # in place
    want = out0.double().numpy()
    want[row0:row0 + n] += numpy_pair(lengths, col, vals, x, 3,
                                      torch.float32)
    for o in (got, plain):
        np.testing.assert_allclose(o.numpy(), want, rtol=1e-6, atol=1e-6)
    keep = torch.ones(n + 5, dtype=torch.bool)
    keep[row0:row0 + n] = torch.from_numpy(lengths == 0)
    assert torch.equal(got[keep], out0[keep])             # bit for bit


def test_pair_is_the_scatter_of_its_messages():
    """csr_pair_spmm computes csr_scatter_sum over the messages
    [val_sel * x[col] | w_sel * x[col]], which the TPU's pair forward
    builds."""
    rowptr, _, col, vals, x = cut_case(3, 5, 8)
    msgs = scatter_csr._pair_msgs(col, *vals, x, 4)
    torch.testing.assert_close(
        scatter_csr.csr_pair_spmm(rowptr, col, *vals, x, 4),
        scatter_csr.csr_scatter_sum(rowptr, msgs), rtol=0, atol=0)


# --- emulations of the kernels' passes --------------------------------------

def emulate_rows(rowptr, msgs, split, out=None, row0=0):
    """The CSR kernels' passes on ``split``: rows of at most piece_len
    edges summed (from their prior in the accumulate mode, only if they
    have edges), one float64 partial per piece, each cut row's partials
    added in piece order to its prior (0 in the plain mode), rounded
    once."""
    rp = rowptr.long()
    n = rp.numel() - 1
    accum = out is not None
    out = out.clone() if accum else torch.zeros((n, msgs.shape[1]))
    m = msgs.double()
    for r in range(n):
        a, b = int(rp[r]), int(rp[r + 1])
        if b - a > split.piece_len or (accum and a == b):
            continue
        prior = out[row0 + r].double() if accum else 0.0
        out[row0 + r] = (prior + m[a:b].sum(0)).float()
    partial = [m[a:b].sum(0) for a, b in split.pieces.long().tolist()]
    for j, r in enumerate(split.rows.tolist()):
        s = out[row0 + r].double() if accum else torch.zeros(
            m.shape[1], dtype=torch.float64)
        for p in range(int(split.ptr[j]), int(split.ptr[j + 1])):
            s = s + partial[p]
        out[row0 + r] = s.float()
    return out


@pytest.mark.parametrize("accum", [False, True])
@pytest.mark.parametrize("piece_len", [1, 3, 8])
def test_pair_emulated_passes_match_the_plain_version(piece_len, accum):
    rowptr, lengths, col, vals, x = cut_case(piece_len + 10, piece_len, 6)
    split = scatter_csr.plan_row_split(rowptr, piece_len)
    assert split.rows.numel() >= 2
    msgs = scatter_csr._pair_msgs(col, *vals, x, 3)
    if accum:
        out0 = torch.randn(len(lengths) + 4, 12,
                           generator=torch.Generator().manual_seed(1))
        got = emulate_rows(rowptr, msgs, split, out0, 2)
        want = scatter_csr.csr_pair_spmm_accum_plain(rowptr, col, *vals, x, 3,
                                                     out0, 2)
    else:
        got = emulate_rows(rowptr, msgs, split)
        want = scatter_csr.csr_pair_spmm_plain(rowptr, col, *vals, x, 3)
    torch.testing.assert_close(got, want, **EMU_TOL)


def emulate_sddmm(rowptr, col, vals, g, x, fa, split):
    """K3's passes on ``split``, in float64: a row of at most piece_len
    edges writes its out sum and adds x[r] * m_row to its CTA's slot; a
    piece writes its out partial (the combine adds a cut row's partials in
    piece order) and adds x[r] * m_piece.  acc is the sum of every term."""
    va, vb, wa, wb = (v.double() for v in vals)
    lane = torch.arange(g.shape[1]) < fa
    ge = g[col.long()].float()
    msgs = (torch.where(lane, va[:, None], vb[:, None]) * ge.double()
            ).float().to(g.dtype).double()
    prods = torch.where(lane, wa[:, None], wb[:, None]) * ge.double()
    rp = rowptr.long()
    n = rp.numel() - 1
    out = torch.zeros((n, g.shape[1]), dtype=torch.float64)
    acc = torch.zeros(g.shape[1], dtype=torch.float64)
    xd = x.double()
    for r in range(n):
        a, b = int(rp[r]), int(rp[r + 1])
        if b - a <= split.piece_len:
            out[r] = msgs[a:b].sum(0)
            acc += xd[r] * prods[a:b].sum(0)
    owner = torch.repeat_interleave(split.rows.long(),
                                    (split.ptr[1:] - split.ptr[:-1]).long())
    partial = []
    for (a, b), r in zip(split.pieces.long().tolist(), owner.tolist()):
        partial.append(msgs[a:b].sum(0))
        acc += xd[r] * prods[a:b].sum(0)
    for j, r in enumerate(split.rows.tolist()):
        out[r] = sum(partial[int(split.ptr[j]):int(split.ptr[j + 1])])
    return out.float(), acc.float()


@pytest.mark.parametrize("piece_len", [1, 3, 8])
def test_sddmm_piece_emulation_matches_plain_and_jax(piece_len):
    rowptr, lengths, col, vals, g = cut_case(piece_len + 20, piece_len, 6)
    n = len(lengths)
    x = torch.from_numpy(np.random.default_rng(piece_len).standard_normal(
        (n, 6)).astype(np.float32))
    split = scatter_csr.plan_row_split(rowptr, piece_len)
    assert split.rows.numel() >= 2
    got = emulate_sddmm(rowptr, col, vals, g, x, 3, split)
    want = dual_sddmm.csr_dual_sddmm_plain(rowptr, col, *vals, g, x, 3)
    torch.testing.assert_close(got[0], want[0], **EMU_TOL)
    torch.testing.assert_close(got[1], want[1], **EMU_TOL)
    # the Pallas K3 (interpret mode) on the same edges in its own plan
    row = np.repeat(np.arange(n), lengths)
    plan, perm = scatter_mxu.build_scatter_plan(row, n)
    cols, *pv = scatter_mxu.permute_edge_data(
        perm, col.numpy(), *(v.numpy() for v in vals))
    jout, jacc = scatter_mxu.dual_scatter_sddmm(
        plan, jnp.asarray(g.numpy())[jnp.asarray(cols)],
        *(jnp.asarray(v) for v in pv), jnp.asarray(x.numpy()), 3)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jout), **F32_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(jacc), **ACC_TOL)


def emulate_scatter_fold(rowptr, msgs, split, p_slots):
    """csr_scatter_sum's order: per row (or piece) P edge slots, slot j
    summing edges start + j, start + j + P, ... in order; the slots meet in
    an xor butterfly (step d adds slot j ^ d to slot j); pieces then meet
    in the combine.  Rows are independent, so how many share a warp does
    not change the order."""
    m = msgs.double()

    def fold(a, b):
        s = [m[a + j:b:p_slots].sum(0) for j in range(p_slots)]
        d = 1
        while d < p_slots:
            s = [s[j] + s[j ^ d] for j in range(p_slots)]
            d *= 2
        assert all(torch.equal(s[0], v) for v in s)   # every slot agrees
        return s[0]

    rp = rowptr.long()
    n = rp.numel() - 1
    out = torch.zeros((n, msgs.shape[1]))
    for r in range(n):
        a, b = int(rp[r]), int(rp[r + 1])
        if b - a <= split.piece_len:
            out[r] = fold(a, b).float()
    partial = [fold(a, b) for a, b in split.pieces.long().tolist()]
    for j, r in enumerate(split.rows.tolist()):
        out[r] = sum(partial[int(split.ptr[j]):int(split.ptr[j + 1])]).float()
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width", [4, 8, 38, 128])
def test_scatter_fold_order_matches_the_plain_version(width, dtype):
    mdt = torch.float32 if dtype == "f32" else torch.bfloat16
    rowptr, lengths, _, _, _ = cut_case(width, 8, 1)
    msgs = torch.randn(int(lengths.sum()), width,
                       generator=torch.Generator().manual_seed(width)).to(mdt)
    v, tl = scatter_csr._msg_geometry(msgs)
    split = scatter_csr.plan_row_split(rowptr, 8)
    # V = 1 (38 lanes): uncut rows are walked a thread a column, one slot;
    # the pieces' warps sum 64 // C slots a tile in slot order, which this
    # emulation's butterfly does not follow (float64 either way)
    got = emulate_scatter_fold(rowptr, msgs, split,
                               1 if v == 1 else
                               min(32 // tl, scatter_csr.MSG_SLOTS))
    torch.testing.assert_close(
        got, scatter_csr.csr_scatter_sum_plain(rowptr, msgs), **EMU_TOL)


@pytest.mark.parametrize("width,dtype,offset,want", [
    (8, torch.float32, 0, (4, 2)),        # the pair forward's W=8
    (128, torch.float32, 0, (4, 32)),     # and W=128
    (8, torch.bfloat16, 0, (8, 1)),
    (128, torch.bfloat16, 0, (8, 16)),
    (300, torch.float32, 0, (4, 32)),     # tiles over blockIdx.y
    (38, torch.float32, 0, (1, 1)),       # rows not 16-byte multiples
    (4, torch.float32, 1, (1, 1)),        # rows not 16-byte aligned
])
def test_msg_geometry(width, dtype, offset, want):
    flat = torch.zeros(10 * width + offset, dtype=dtype)
    msgs = flat[offset:].view(10, width)
    assert scatter_csr._msg_geometry(msgs) == want


def piece_sums(m, block):
    """The float64 sum of a row's pieces (PIECE_EDGES edges each), each
    piece summed in float32 as the pair walk does: ``block`` products at a
    time summed plainly, each batch sum added with Kahan compensation (1: a
    compensated add per edge; 0: a plain float32 sum).  Vectorised over the
    pieces; numpy rounds every float32 operation once."""
    f32 = np.float32
    p = m.reshape(-1, scatter_csr.PIECE_EDGES)
    s, c = np.zeros(p.shape[0], f32), np.zeros(p.shape[0], f32)
    for j in range(0, p.shape[1], max(block, 1)):
        if block == 0:
            s = s + p[:, j]
            continue
        b = np.zeros_like(s)
        for v in p[:, j:j + block].T:
            b = b + v
        y = b - c
        t = s + y
        c = (t - s) - y
        s = t
    return float((s.astype(np.float64) - c.astype(np.float64)).sum())


def test_batch_compensated_sum_is_as_close_as_per_edge_on_a_hub_row():
    """The pair walk adds each batch of 8 products plainly and the batch
    sum compensated.  On rows the length of the giant graph's hub (316
    pieces) it stays within about twice the error of a compensated add per
    edge (~1e-5 absolute on sums of ~3e5 terms of size ~1) and over ten
    times below a plain float32 sum's."""
    errs = {1: [], 8: [], 0: []}
    for seed in range(6):
        rng = np.random.default_rng(seed)
        n = 316 * scatter_csr.PIECE_EDGES
        m = (rng.standard_normal(n, dtype=np.float32)
             * rng.standard_normal(n, dtype=np.float32))
        exact = m.astype(np.float64).sum()
        for block in errs:
            errs[block].append(abs(piece_sums(m, block) - exact))
    per_edge, batch, plain = (np.mean(errs[b]) for b in (1, 8, 0))
    assert batch < 3 * per_edge
    assert batch < plain / 10
    assert max(errs[8]) < 1e-4


def hub_row_errors(blocks, rows=48, seed=100):
    """The mean absolute error against float64 of ``rows`` independent
    rows the length of the giant graph's hub (316 pieces) of products of
    two standard normals, summed as piece_sums does for each ``block``;
    the rows' pieces in one vectorised pass."""
    L = scatter_csr.PIECE_EDGES
    rng = np.random.default_rng(seed)
    m = (rng.standard_normal((rows, 316 * L), dtype=np.float32)
         * rng.standard_normal((rows, 316 * L), dtype=np.float32))
    exact = m.astype(np.float64).sum(1)
    pieces = m.reshape(-1, L)
    errs = {}
    for block in blocks:
        s = np.zeros(len(pieces), np.float32)
        c = np.zeros_like(s)
        for j in range(0, L, max(block, 1)):
            if block == 0:
                s = s + pieces[:, j]
                continue
            b = np.zeros_like(s)
            for v in pieces[:, j:j + block].T:
                b = b + v
            y = b - c
            t = s + y
            c = (t - s) - y
            s = t
        got = (s.astype(np.float64) - c.astype(np.float64)).reshape(
            rows, -1).sum(1)
        errs[block] = float(np.abs(got - exact).mean())
    return errs


@pytest.mark.parametrize("depth", [4, 8])
def test_dual_batch_sum_on_a_hub_row(depth):
    """PairSource's batch sums (D products plainly, the batch sum
    compensated) at the dual's batch depths (D = 4 at 2 or 8 lanes a
    thread, 8 otherwise) over 48 rows the length of the giant graph's
    hub: within 3x the error of a compensated add an edge (2.2x in
    expectation) and five times below a plain float32 sum's (10.2x in
    expectation: the ratio grows as the square root of the piece length,
    so ten times cannot be held from a sample).  The dual keeps a
    compensated add an edge: on the card its batch sums missed the hub
    row's f32 tolerance in tests/test_torch_cuda.py, and their registers
    cost the walk an SM's fourth CTA (csrc/scatter_csr.cu)."""
    errs = hub_row_errors((1, depth, 0))
    assert errs[depth] < 3 * errs[1]
    assert errs[depth] < errs[0] / 5


# --- the pair forward against the JAX package --------------------------------

def zipf_graph(n, e, seed):
    rng = np.random.default_rng(seed)
    ei = np.vstack([rng.integers(0, n, e), (rng.zipf(1.3, e) - 1) % n])
    return ei, rng.random(e).astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("f2", [4, 64, 192])
@pytest.mark.parametrize("kind", list(KINDS))
def test_template_pair_forward_matches_jax(kind, f2, dtype, knobs):
    """2F = 4 and 64 are the trainable-q path's widths; 192 (4F = 384) is
    past the TPU kernels' 256 lanes, where the JAX package takes two
    passes and the port one."""
    knobs(**KINDS[kind])
    n = 512
    ei, w = zipf_graph(n, 6000, seed=f2)
    t = magnetic_template(ei, w, num_nodes=n, mode="mxu", device="cpu")
    j = jx_magnetic_template(ei, w, num_nodes=n, mode="mxu")
    assert (t.hot_ids is not None) == (kind == "split")
    assert t.streamed == (kind == "streamed") == (j.stream is not None)
    x = np.random.default_rng(f2 + 1).standard_normal((n, f2)).astype(
        np.float32)
    q = 0.19
    mdt = None if dtype == "f32" else "bf16"
    spmm.set_message_dtype(mdt)
    jx_spmm.set_message_dtype(mdt)
    try:
        y, yp = magnetic_mod._template_pair_forward(
            t, torch.tensor(q), torch.from_numpy(x))
        jy, jyp = jx_magnetic._template_pair_forward(j, q, jnp.asarray(x))
    finally:
        spmm.set_message_dtype(None)
        jx_spmm.set_message_dtype(None)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    assert y.shape == yp.shape == (n, f2)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(yp.numpy(), np.asarray(jyp), **tol)
