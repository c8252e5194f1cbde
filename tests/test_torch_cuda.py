"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card (a CUDA kernel has no CPU mode) and skip
without one.  This file imports neither JAX nor the tests' conftest, so
on a machine with a card it runs as

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from pytorch_geometric_signed_directed_tpu_torch.instrument import reset_counts
from pytorch_geometric_signed_directed_tpu_torch.ops import (
    build_coo, layout, spmm)
from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
    bsr_spmm, dual_sddmm, scatter_csr)

# f32: the kernels sum in compensated float32, the plain versions in
# float64 with atomics in no fixed order
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 messages: both round every message to bf16, then sum in f32
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def operator(n_rows, n_cols, e, seed):
    """Random edge list with duplicate edges and empty (odd) rows."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n_rows // 2, e) * 2
    col = rng.integers(0, n_cols, e)
    row[: e // 10], col[: e // 10] = row[-(e // 10):], col[-(e // 10):]
    va = rng.standard_normal(e).astype(np.float32)
    vb = rng.standard_normal(e).astype(np.float32)
    return row, col, va, vb


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width", [2, 4, 38, 64, 300])
def test_kernels_match_plain_on_card(card, width, dtype):
    mdt = torch.float32 if dtype == "f32" else torch.bfloat16
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    n_rows, n_cols, e = 3000, 2000, 40000
    row, col, va, vb = operator(n_rows, n_cols, e, seed=width)
    D = spmm.dual_propagator(row, col, va, vb, n_rows, n_cols, mode="mxu",
                             device=card)
    x = torch.randn(n_cols, width, device=card).to(mdt)
    args = (D.rowptr, D.col, D.val_a, D.val_b, x, width // 2)
    before = scatter_csr.LAUNCHES["csr_dual_spmm"]
    got = scatter_csr.csr_dual_spmm(*args)
    assert scatter_csr.LAUNCHES["csr_dual_spmm"] == before + 1
    torch.testing.assert_close(got, scatter_csr.csr_dual_spmm_plain(*args),
                               **tol)
    assert torch.equal(got, scatter_csr.csr_dual_spmm(*args))  # no atomics
    assert torch.all(got[1::2] == 0)                           # empty rows
    msgs = torch.randn(e, width, device=card).to(mdt)
    before = scatter_csr.LAUNCHES["csr_scatter_sum"]
    torch.testing.assert_close(
        scatter_csr.csr_scatter_sum(D.rowptr, msgs),
        scatter_csr.csr_scatter_sum_plain(D.rowptr, msgs), **tol)
    assert scatter_csr.LAUNCHES["csr_scatter_sum"] == before + 1
    # message rows that do not start 16-byte aligned take scalar loads
    shifted = torch.randn(e * width + 1, device=card).to(mdt)[1:].view(
        e, width)
    assert scatter_csr._msg_geometry(shifted)[0] == 1
    torch.testing.assert_close(
        scatter_csr.csr_scatter_sum(D.rowptr, shifted),
        scatter_csr.csr_scatter_sum_plain(D.rowptr, shifted), **tol)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_dual_spmm_stacked_backward_on_card(card):
    """The autograd path on the card: forward and transposed backward
    against the plain segment tier."""
    row, col, va, vb = operator(3000, 2000, 40000, seed=3)
    D = spmm.dual_propagator(row, col, va, vb, 3000, 2000, mode="mxu",
                             device=card)
    S = spmm.dual_propagator(row, col, va, vb, 3000, 2000, mode="segment",
                             device=card)
    x = torch.randn(2000, 64, device=card, requires_grad=True)
    g = torch.randn(3000, 64, device=card)
    outs, grads = [], []
    for op in (D, S):
        out = spmm.dual_spmm_stacked(op, x)
        outs.append(out)
        grads.append(torch.autograd.grad(out, x, g)[0])
    torch.testing.assert_close(outs[0], outs[1], **F32_TOL)
    torch.testing.assert_close(grads[0], grads[1], **F32_TOL)


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs_on_card(card):
    row, col, va, vb = operator(300, 200, 4000, seed=4)
    D = spmm.dual_propagator(row, col, va, vb, 300, 200, mode="mxu",
                             device=card)
    x = torch.randn(200, 8, device=card)
    with pytest.raises(TypeError):
        scatter_csr.csr_dual_spmm(D.rowptr, D.col.long(), D.val_a, D.val_b,
                                  x, 4)
    with pytest.raises(ValueError, match="contiguous"):
        scatter_csr.csr_dual_spmm(D.rowptr, D.col, D.val_a, D.val_b,
                                  x.t().contiguous().t(), 4)
    with pytest.raises(ValueError, match="expected"):
        scatter_csr.csr_dual_spmm(D.rowptr, D.col, D.val_a, D.val_b.cpu(),
                                  x, 4)


# --- K2: the accumulate entries --------------------------------------------

def block(n_rows, n_cols, e, seed):
    """One block of a layout: a local rowptr over ``n_rows`` rows (odd rows
    without edges) and its edges in row order."""
    row, col, va, vb = operator(n_rows, n_cols, e, seed)
    order = np.argsort(row, kind="stable")
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(row,
                                                        minlength=n_rows))])
    return (torch.from_numpy(rowptr.astype(np.int32)),
            torch.from_numpy(col[order].astype(np.int32)),
            torch.from_numpy(va[order]), torch.from_numpy(vb[order]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width", [4, 38, 64, 300])
def test_accumulate_kernels_match_plain_on_card(card, width, dtype):
    mdt = torch.float32 if dtype == "f32" else torch.bfloat16
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    n, m, e, row0, n_out = 1000, 2000, 20000, 700, 2500
    rowptr, col, va, vb = (t.to(card) for t in block(n, m, e, seed=width))
    x = torch.randn(m, width, device=card).to(mdt)
    out0 = torch.randn(n_out, width, device=card)
    before = dict(scatter_csr.LAUNCHES)
    got = scatter_csr.csr_dual_spmm_accum(rowptr, col, va, vb, x, width // 2,
                                          out0.clone(), row0)
    want = scatter_csr.csr_dual_spmm_accum_plain(rowptr, col, va, vb, x,
                                                 width // 2, out0, row0)
    torch.testing.assert_close(got, want, **tol)
    # rows outside the block, and the block's rows without edges, keep
    # their prior values bit for bit
    untouched = torch.ones(n_out, dtype=torch.bool, device=card)
    untouched[row0:row0 + n:2] = False
    assert torch.equal(got[untouched], out0[untouched])
    msgs = torch.randn(e, width, device=card).to(mdt)
    got = scatter_csr.csr_scatter_accum(rowptr, msgs, out0.clone(), row0)
    torch.testing.assert_close(
        got, scatter_csr.csr_scatter_accum_plain(rowptr, msgs, out0, row0),
        **tol)
    assert torch.equal(got[untouched], out0[untouched])
    assert scatter_csr.LAUNCHES["csr_dual_spmm_accum"] == \
        before["csr_dual_spmm_accum"] + 1
    assert scatter_csr.LAUNCHES["csr_scatter_accum"] == \
        before["csr_scatter_accum"] + 1
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("accum", [False, True])
def test_hub_row_sums_are_compensated_on_card(card, accum):
    """One row of 300,000 edges: the compensated float32 sum stays at the
    float64 sum (a plain float32 sum drifts by about 1e-5 here)."""
    e, m, w = 300_000, 5000, 64
    gen = torch.Generator(device=card).manual_seed(0)
    rowptr = torch.tensor([0, e], dtype=torch.int32, device=card)
    col = torch.randint(0, m, (e,), generator=gen, device=card,
                        dtype=torch.int32)
    va = torch.randn(e, generator=gen, device=card) / e ** 0.5
    vb = torch.randn(e, generator=gen, device=card) / e ** 0.5
    x = torch.randn(m, w, generator=gen, device=card)
    if accum:
        out0 = torch.randn(3, w, generator=gen, device=card)
        got = scatter_csr.csr_dual_spmm_accum(rowptr, col, va, vb, x, w // 2,
                                              out0.clone(), 1)
        want = scatter_csr.csr_dual_spmm_accum_plain(rowptr, col, va, vb, x,
                                                     w // 2, out0, 1)
    else:
        got = scatter_csr.csr_dual_spmm(rowptr, col, va, vb, x, w // 2)
        want = scatter_csr.csr_dual_spmm_plain(rowptr, col, va, vb, x, w // 2)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width", [5, 10])
def test_accumulate_on_a_hub_row_at_the_imbalance_widths_on_card(card, width,
                                                                 dtype):
    """K2 at the widths of DIGRAC's imbalance volumes (A P at W=5, the A
    dual at 2K=10: not multiples of 4) on one row of 300,000 edges cut
    into pieces, into a non-zero output: both round each message alike,
    so the compensated float32 sum stays at the plain version's float64
    sum, and rows without edges keep their values."""
    e, m = 300_000, 5000
    gen = torch.Generator(device=card).manual_seed(width)
    rowptr = torch.tensor([0, 0, e, e], dtype=torch.int32, device=card)
    split = scatter_csr.plan_row_split(rowptr)
    assert split.rows.tolist() == [1]
    col = torch.randint(0, m, (e,), generator=gen, device=card,
                        dtype=torch.int32)
    va = torch.rand(e, generator=gen, device=card) / e ** 0.5
    vb = torch.rand(e, generator=gen, device=card) / e ** 0.5
    x = torch.rand(m, width, generator=gen, device=card)
    if dtype == "bf16":
        x = x.to(torch.bfloat16)
    out0 = torch.randn(5, width, generator=gen, device=card)
    args = (rowptr, col, va, vb, x, width // 2)
    got = scatter_csr.csr_dual_spmm_accum(*args, out0.clone(), 1, split)
    want = scatter_csr.csr_dual_spmm_accum_plain(*args, out0, 1)
    torch.testing.assert_close(got, want, **F32_TOL)
    assert torch.equal(got[[0, 1, 3, 4]], out0[[0, 1, 3, 4]])
    again = scatter_csr.csr_dual_spmm_accum(*args, out0.clone(), 1, split)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["split", "streamed", "split_streamed"])
def test_layouts_match_flat_layout_on_card(card, kind, monkeypatch):
    """The split and streamed duals on the card (K2, one launch per block)
    against the flat one (K1): forward and transposed backward.  Both sum
    every row in compensated float32, so they agree to rounding even on
    the hub row of 12,000 edges."""
    rng = np.random.default_rng(7)
    n, e = 3000, 40000
    row = np.concatenate([np.full(12000, 17), rng.integers(0, n, e - 12000)])
    col = (rng.zipf(1.3, e) - 1) % n          # skewed column degrees
    va = rng.standard_normal(e).astype(np.float32)
    vb = rng.standard_normal(e).astype(np.float32)
    flat = spmm.dual_propagator(row, col, va, vb, n, mode="mxu", device=card)
    if "split" in kind:
        monkeypatch.setattr(layout, "COL_SPLIT_MIN_COLS", 100)
        monkeypatch.setattr(layout, "GATHER_FAST_ROWS", 64)
        monkeypatch.setattr(layout, "COL_SPLIT_MIN_COVERAGE", 0.0)
    if "streamed" in kind:
        monkeypatch.setattr(layout, "STREAM_THRESHOLD_EDGES", 5000)
        monkeypatch.setattr(layout, "STREAM_BLOCK_EDGES", 4096)
    D = spmm.dual_propagator(row, col, va, vb, n, mode="mxu", device=card)
    assert flat.rowptr is not None and D.rowptr is None
    assert (D.hot_ids is not None) == ("split" in kind)
    assert D.streamed == ("streamed" in kind)
    x = torch.randn(n, 64, device=card, requires_grad=True)
    g = torch.randn(n, 64, device=card)
    outs, grads = [], []
    for op in (flat, D):
        reset_counts()
        out = spmm.dual_spmm_stacked(op, x)
        outs.append(out)
        grads.append(torch.autograd.grad(out, x, g)[0])
    torch.testing.assert_close(outs[1], outs[0], **F32_TOL)
    torch.testing.assert_close(grads[1], grads[0], **F32_TOL)
    assert scatter_csr.LAUNCHES["csr_dual_spmm_accum"] == \
        len(D.blocks) + len(D.transposed.blocks)
    assert scatter_csr.LAUNCHES["csr_dual_spmm"] == 0


# --- the cut rows of K1/K2 ---------------------------------------------------

def hub_csr(device, seed=0):
    """A CSR with the giant graph's largest row (324,064 edges), rows one
    edge shorter than, as long as and one edge longer than a piece, a row
    of two pieces and a bit, empty rows, and short rows."""
    L = scatter_csr.PIECE_EDGES
    rng = np.random.default_rng(seed)
    lengths = np.concatenate([[0, 324_064, 0, L - 1, L, L + 1, 2 * L + 5, 0],
                              rng.integers(0, 40, 500), [0, L + 1]])
    rowptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    return torch.from_numpy(rowptr).to(device), lengths


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("entry", ["csr_dual_spmm", "csr_scatter_sum",
                                   "csr_dual_spmm_accum",
                                   "csr_scatter_accum", "csr_pair_spmm",
                                   "csr_pair_spmm_accum"])
def test_cut_rows_match_plain_and_repeat_bit_for_bit_on_card(card, entry,
                                                             dtype):
    """Every CSR entry on a hub row and rows around the piece length,
    accumulating into a non-zero output: against its plain version, and
    bit-equal across two calls (no atomics)."""
    mdt = torch.float32 if dtype == "f32" else torch.bfloat16
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    rowptr, lengths = hub_csr(card)
    split = scatter_csr.plan_row_split(rowptr)
    assert split.rows.numel() == int((lengths > scatter_csr.PIECE_EDGES).sum())
    n, e, m, w, row0 = len(lengths), int(lengths.sum()), 5000, 64, 3
    gen = torch.Generator(device=card).manual_seed(len(entry))
    if "scatter" not in entry:
        col = torch.randint(0, m, (e,), generator=gen, device=card,
                            dtype=torch.int32)
        vals = torch.randn(4 if "pair" in entry else 2, e, generator=gen,
                           device=card)
        x = torch.randn(m, w, generator=gen, device=card).to(mdt)
        args = (rowptr, col, *vals, x, w // 2)
    else:
        args = (rowptr, torch.randn(e, w, generator=gen,
                                    device=card).to(mdt))
    fn = getattr(scatter_csr, entry)
    plain = getattr(scatter_csr, entry + "_plain")
    out0 = torch.randn(n + 2 * row0, (2 if "pair" in entry else 1) * w,
                       generator=gen, device=card)
    if entry.endswith("_accum"):
        got = fn(*args, out0.clone(), row0, split=split)
        again = fn(*args, out0.clone(), row0, split=split)
        unplanned = fn(*args, out0.clone(), row0)
        want = plain(*args, out0, row0)
        # rows without edges, and rows outside the block, keep their bits
        keep = torch.ones(len(out0), dtype=torch.bool, device=card)
        keep[row0:row0 + n] = torch.from_numpy(lengths == 0).to(card)
        assert torch.equal(got[keep], out0[keep])
    else:
        got = fn(*args, split=split)
        again = fn(*args, split=split)
        unplanned = fn(*args)
        want = plain(*args)
        assert torch.all(got[torch.from_numpy(lengths == 0).to(card)] == 0)
    torch.testing.assert_close(got, want, **tol)
    assert torch.equal(got, again)
    assert torch.equal(got, unplanned)
    torch.cuda.synchronize()


# --- K5: the block-sparse kernel -------------------------------------------

def bsr_operator(n_rows, n_cols, e, seed, device):
    """Rectangular operator whose block rows 1 and 3 hold no entries."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n_rows, e)
    row = row[(row // 128 != 1) & (row // 128 != 3)]
    col = rng.integers(0, n_cols, len(row))
    val = rng.standard_normal(len(row)).astype(np.float32)
    return build_coo(row, col, val, n_rows, num_cols=n_cols, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2, 5, 32, 40])
def test_bsr_kernel_matches_plain_on_card(card, width):
    from pytorch_geometric_signed_directed_tpu_torch.ops.bsr import (
        bsr_from_coo)

    B = bsr_from_coo(bsr_operator(700, 520, 6000, seed=width, device=card))
    outs = []
    for op, cols in ((B, 520), (B.transposed, 700)):
        x = torch.randn(cols, width, device=card)
        args = (op.blocks, op.block_rowptr, op.block_cols, x, op.num_rows)
        before = bsr_spmm.LAUNCHES["bsr_spmm"]
        outs.append(bsr_spmm.bsr_matmul(*args))
        assert bsr_spmm.LAUNCHES["bsr_spmm"] == before + 1
        torch.testing.assert_close(outs[-1],
                                   bsr_spmm.bsr_matmul_plain(*args),
                                   **F32_TOL)
    # the forward's empty block rows
    assert torch.all(outs[0][128:256] == 0)
    assert torch.all(outs[0][384:512] == 0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2, 32])
def test_bsr_kernel_on_few_unequal_block_rows_on_card(card, width):
    """Ten block rows (fewer than the card's SMs), one of 200 blocks and
    others of one or two, under the planned split and a coarser one:
    against the plain version, bit-equal across two calls."""
    from pytorch_geometric_signed_directed_tpu_torch.ops.bsr import (
        bsr_from_coo)

    rng = np.random.default_rng(width)
    n_rows, n_cols = 1280, 200 * 128
    per_row = [200, 1, 0, 50, 2, 2, 1, 2, 1, 2]      # blocks per block row
    row, col = [], []
    for br, k in enumerate(per_row):
        for bc in rng.choice(200, k, replace=False):
            row.append(br * 128 + rng.integers(0, 128, 20))
            col.append(bc * 128 + rng.integers(0, 128, 20))
    row, col = np.concatenate(row), np.concatenate(col)
    val = rng.standard_normal(len(row)).astype(np.float32)
    B = bsr_from_coo(build_coo(row, col, val, n_rows, num_cols=n_cols,
                               device=card))
    for op in (B, B.transposed):
        x = torch.randn(op.num_cols, width, device=card)
        args = (op.blocks, op.block_rowptr, op.block_cols, x, op.num_rows)
        want = bsr_spmm.bsr_matmul_plain(*args)
        coarse = bsr_spmm.plan_block_split(op.block_rowptr,
                                           op.blocks.shape[0], n_sms=2)
        for split in (op.split, coarse):
            got = bsr_spmm.bsr_matmul(*args, split=split)
            torch.testing.assert_close(got, want, **F32_TOL)
            assert torch.equal(got, bsr_spmm.bsr_matmul(*args, split=split))
    torch.cuda.synchronize()


def bsr_x(op, width, card, offset):
    """x [op.num_cols, width], as a view at storage offset 1 (a base off 16
    bytes) when ``offset``."""
    n = op.num_cols * width
    flat = torch.randn(n + offset, device=card)[offset:]
    return flat.view(op.num_cols, width)


BSR_WIDTH_CASES = ("full grid", "rectangular", "x off 16 bytes")


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2, 3, 8, 9, 16, 31, 32, 33, 64, 100])
@pytest.mark.parametrize("case", BSR_WIDTH_CASES)
def test_bsr_tensor_core_kernel_at_every_width_on_card(card, case, width):
    """K5 (3xTF32 on the tensor cores) at feature tiles of 8 to 64 lanes,
    ragged and whole, against its plain version: a fully occupied 8 x 8
    block grid (N=1024, 24 entries a row), the rectangular operator with
    empty block rows and its transpose, and x from a base off 16 bytes
    (4-byte copies); two calls give the same bits."""
    from pytorch_geometric_signed_directed_tpu_torch.ops.bsr import (
        bsr_from_coo)

    if case == "rectangular":
        B = bsr_from_coo(bsr_operator(700, 520, 6000, seed=width,
                                      device=card))
        ops = (B, B.transposed)
    else:
        rng = np.random.default_rng(width)
        n = 1024
        row, col = rng.integers(0, n, 24 * n), rng.integers(0, n, 24 * n)
        val = rng.standard_normal(24 * n).astype(np.float32)
        B = bsr_from_coo(build_coo(row, col, val, n, device=card))
        assert B.blocks.shape[0] == 64
        ops = (B,)
    for op in ops:
        x = bsr_x(op, width, card, offset=int(case == "x off 16 bytes"))
        if case == "x off 16 bytes":
            assert x.data_ptr() % 16 == 4
        args = (op.blocks, op.block_rowptr, op.block_cols, x, op.num_rows)
        got = bsr_spmm.bsr_matmul(*args, op.split)
        torch.testing.assert_close(got, bsr_spmm.bsr_matmul_plain(*args),
                                   **F32_TOL)
        assert torch.equal(got, bsr_spmm.bsr_matmul(*args, op.split))
    if case == "rectangular":
        out = bsr_spmm.bsr_matmul(B.blocks, B.block_rowptr, B.block_cols,
                                  torch.randn(520, width, device=card), 700)
        assert not out[128:256].any() and not out[384:512].any()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_bsr_propagator_backward_on_card(card):
    A = bsr_operator(700, 700, 6000, seed=3, device=card)
    P = spmm.propagator_from_coo(A, mode="bsr")
    S = spmm.propagator_from_coo(A, mode="segment")
    x = torch.randn(700, 32, device=card, requires_grad=True)
    g = torch.randn(700, 32, device=card)
    outs, grads = [], []
    for op in (P, S):
        out = op(x)
        outs.append(out)
        grads.append(torch.autograd.grad(out, x, g)[0])
    torch.testing.assert_close(outs[0], outs[1], **F32_TOL)
    torch.testing.assert_close(grads[0], grads[1], **F32_TOL)


@pytest.mark.cuda
def test_bsr_wrapper_rejects_bad_inputs_on_card(card):
    from pytorch_geometric_signed_directed_tpu_torch.ops.bsr import (
        bsr_from_coo)

    B = bsr_from_coo(bsr_operator(300, 300, 2000, seed=4, device=card))
    x = torch.randn(300, 8, device=card)
    with pytest.raises(TypeError):
        bsr_spmm.bsr_matmul(B.blocks, B.block_rowptr, B.block_cols,
                            x.double(), 300)
    with pytest.raises(ValueError, match="block rows"):
        bsr_spmm.bsr_matmul(B.blocks, B.block_rowptr, B.block_cols, x, 600)


# --- K3 and K4: the fused scatter + SDDMM ----------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width", [2, 4, 38, 64, 300])
def test_sddmm_kernels_match_plain_on_card(card, width, dtype):
    mdt = torch.float32 if dtype == "f32" else torch.bfloat16
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    n, m, e, row0, n_out = 1000, 2000, 20000, 700, 2500
    rowptr, col, va, vb = (t.to(card) for t in block(n, m, e, seed=width))
    wa, wb = torch.randn(2, e, device=card)
    g = torch.randn(m, width, device=card).to(mdt)
    x = torch.randn(n, width, device=card)
    fa = width // 2
    args = (rowptr, col, va, vb, wa, wb, g, x, fa)
    before = dict(dual_sddmm.LAUNCHES)
    out, acc = dual_sddmm.csr_dual_sddmm(*args)
    want_out, want_acc = dual_sddmm.csr_dual_sddmm_plain(*args)
    torch.testing.assert_close(out, want_out, **tol)
    torch.testing.assert_close(acc, want_acc, rtol=1e-4, atol=1e-4)
    again = dual_sddmm.csr_dual_sddmm(*args)                  # no atomics
    assert torch.equal(out, again[0]) and torch.equal(acc, again[1])
    assert torch.all(out[1::2] == 0)                           # empty rows
    # K4: the same block at row offset row0 of a larger output
    x_big = torch.randn(n_out, width, device=card)
    out0 = torch.randn(n_out, width, device=card)
    acc0 = torch.randn(width, device=card)
    kargs = (rowptr, col, va, vb, wa, wb, g, x_big, fa)
    got = dual_sddmm.csr_dual_sddmm_accum(*kargs, out0.clone(), acc0.clone(),
                                          row0)
    want = dual_sddmm.csr_dual_sddmm_accum_plain(*kargs, out0, acc0, row0)
    torch.testing.assert_close(got[0], want[0], **tol)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)
    untouched = torch.ones(n_out, dtype=torch.bool, device=card)
    untouched[row0:row0 + n:2] = False
    assert torch.equal(got[0][untouched], out0[untouched])
    assert dual_sddmm.LAUNCHES["csr_dual_sddmm"] == \
        before["csr_dual_sddmm"] + 2
    assert dual_sddmm.LAUNCHES["csr_dual_sddmm_accum"] == \
        before["csr_dual_sddmm_accum"] + 1
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_sddmm_hub_row_is_compensated_on_card(card):
    e, m, w = 300_000, 5000, 64
    gen = torch.Generator(device=card).manual_seed(1)
    rowptr = torch.tensor([0, e], dtype=torch.int32, device=card)
    col = torch.randint(0, m, (e,), generator=gen, device=card,
                        dtype=torch.int32)
    va, vb, wa, wb = torch.randn(4, e, generator=gen, device=card) / e ** 0.5
    g = torch.randn(m, w, generator=gen, device=card)
    x = torch.randn(1, w, generator=gen, device=card)
    args = (rowptr, col, va, vb, wa, wb, g, x, w // 2)
    for a, b in zip(dual_sddmm.csr_dual_sddmm(*args),
                    dual_sddmm.csr_dual_sddmm_plain(*args)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_sharded_template_backward_runs_k3_on_card(card):
    """The one-card mesh: the sharded template's forward (K1) and backward
    (K3) against the flat template's (K1 pair forward, K1 dx)."""
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        launch_counts)
    from pytorch_geometric_signed_directed_tpu_torch.parallel import (
        local_mesh, shard_magnet_laplacian)
    from pytorch_geometric_signed_directed_tpu_torch.spectral import (
        magnetic_template, template_dual_apply)

    rng = np.random.default_rng(5)
    n = 3000
    ei = np.vstack([rng.integers(0, n, 30000), rng.integers(0, n, 30000)])
    flat = magnetic_template(ei, None, num_nodes=n, mode="mxu", device=card)
    sharded = shard_magnet_laplacian(flat, local_mesh())
    x = torch.randn(n, 64, device=card)
    g = torch.randn(n, 64, device=card)
    res = []
    for t in (flat, sharded):
        reset_counts()
        q = torch.tensor(0.2, device=card, requires_grad=True)
        xx = x.clone().requires_grad_(True)
        y = template_dual_apply(t, q, xx)
        (y * g).sum().backward()
        res.append((y.detach(), q.grad, xx.grad, launch_counts()))
    (y0, dq0, dx0, c0), (y1, dq1, dx1, c1) = res
    torch.testing.assert_close(y1, y0, **F32_TOL)
    torch.testing.assert_close(dx1, dx0, **F32_TOL)
    torch.testing.assert_close(dq1, dq0, rtol=1e-4, atol=1e-5)
    assert c0["csr_pair_spmm"] == 1 and c0["csr_dual_spmm"] == 1
    assert c0["csr_scatter_sum"] == 0
    assert c1["csr_dual_spmm"] == 1 and c1["csr_dual_sddmm"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("accum", [False, True])
def test_sddmm_cut_rows_match_plain_and_repeat_bit_for_bit_on_card(card,
                                                                   accum):
    """K3 and K4 on the hub CSR: pieces' out partials through the combine,
    their dq terms through the CTA slots; against the plain version, the
    same bits twice and unplanned, rows without edges untouched (K4)."""
    rowptr, lengths = hub_csr(card, seed=1)
    split = scatter_csr.plan_row_split(rowptr)
    n, e, m, w, row0 = len(lengths), int(lengths.sum()), 5000, 64, 3
    gen = torch.Generator(device=card).manual_seed(11)
    col = torch.randint(0, m, (e,), generator=gen, device=card,
                        dtype=torch.int32)
    va, vb, wa, wb = torch.randn(4, e, generator=gen, device=card)
    g = torch.randn(m, w, generator=gen, device=card)
    x = torch.randn(n + 2 * row0, w, generator=gen, device=card)
    out0 = torch.randn(n + 2 * row0, w, generator=gen, device=card)
    acc0 = torch.randn(w, generator=gen, device=card)
    args = (rowptr, col, va, vb, wa, wb, g)
    if accum:
        def run(**kw):
            return dual_sddmm.csr_dual_sddmm_accum(
                *args, x, w // 2, out0.clone(), acc0.clone(), row0, **kw)
        want = dual_sddmm.csr_dual_sddmm_accum_plain(*args, x, w // 2, out0,
                                                     acc0, row0)
    else:
        def run(**kw):
            return dual_sddmm.csr_dual_sddmm(*args, x[row0:row0 + n], w // 2,
                                             **kw)
        want = dual_sddmm.csr_dual_sddmm_plain(*args, x[row0:row0 + n],
                                               w // 2)
    got, again, unplanned = run(split=split), run(split=split), run()
    torch.testing.assert_close(got[0], want[0], **F32_TOL)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)
    for other in (again, unplanned):
        assert torch.equal(got[0], other[0]) and torch.equal(got[1], other[1])
    empty = torch.from_numpy(lengths == 0).to(card)
    if accum:
        keep = torch.ones(n + 2 * row0, dtype=torch.bool, device=card)
        keep[row0:row0 + n] = empty
        assert torch.equal(got[0][keep], out0[keep])
    else:
        assert torch.all(got[0][empty] == 0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width", [2, 4, 38, 64, 300])
def test_pair_kernels_match_plain_on_card(card, width, dtype):
    """csr_pair_spmm and its accumulate mode against their plain versions,
    duplicate edges and empty rows included; the same bits twice."""
    mdt = torch.float32 if dtype == "f32" else torch.bfloat16
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    n, m, e, row0, n_out = 1000, 2000, 20000, 700, 2500
    rowptr, col, va, vb = (t.to(card) for t in block(n, m, e, seed=width))
    wa, wb = torch.randn(2, e, device=card)
    x = torch.randn(m, width, device=card).to(mdt)
    args = (rowptr, col, va, vb, wa, wb, x, width // 2)
    before = dict(scatter_csr.LAUNCHES)
    got = scatter_csr.csr_pair_spmm(*args)
    assert got.shape == (n, 2 * width)
    torch.testing.assert_close(got, scatter_csr.csr_pair_spmm_plain(*args),
                               **tol)
    assert torch.equal(got, scatter_csr.csr_pair_spmm(*args))
    assert torch.all(got[1::2] == 0)
    out0 = torch.randn(n_out, 2 * width, device=card)
    acc = scatter_csr.csr_pair_spmm_accum(*args, out0.clone(), row0)
    torch.testing.assert_close(
        acc, scatter_csr.csr_pair_spmm_accum_plain(*args, out0, row0), **tol)
    untouched = torch.ones(n_out, dtype=torch.bool, device=card)
    untouched[row0:row0 + n:2] = False
    assert torch.equal(acc[untouched], out0[untouched])
    assert scatter_csr.LAUNCHES["csr_pair_spmm"] == \
        before["csr_pair_spmm"] + 2
    assert scatter_csr.LAUNCHES["csr_pair_spmm_accum"] == \
        before["csr_pair_spmm_accum"] + 1
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 3, 5, 16])
def test_one_edge_rows_on_card(card, width):
    """A diagonal operator (the balanced cut's D_bar: one edge a row, some
    rows empty) through K1 as a single operator (fa = width)."""
    n = 5000
    d = np.random.default_rng(width).uniform(0.5, 9.0, n).astype(np.float32)
    d[::7] = 0.0
    keep = np.nonzero(d)[0]
    P = spmm.make_propagator(keep, keep, d[keep], n, mode="mxu", device=card)
    c = P.csr
    x = torch.randn(n, width, device=card)
    args = (c.rowptr, c.col, c.val, c.val, x, width)
    got = scatter_csr.csr_dual_spmm(*args, c.row_split)
    torch.testing.assert_close(got, scatter_csr.csr_dual_spmm_plain(*args),
                               **F32_TOL)
    torch.testing.assert_close(got, torch.from_numpy(d).to(card)[:, None] * x,
                               **F32_TOL)
    assert torch.equal(got, scatter_csr.csr_dual_spmm(*args, c.row_split))


def _signed_model_outputs(kind, device):
    """Loss and every parameter gradient of a small SSSNET (balanced cut
    and triplet loss) or SGCN (its loss, pair or fused operators) on
    ``device``, from one seed; the operators on the kernel tier."""
    from pytorch_geometric_signed_directed_tpu_torch.data import SSBM
    from pytorch_geometric_signed_directed_tpu_torch.graph import (
        rw_norm_propagator)
    from pytorch_geometric_signed_directed_tpu_torch.nn import (
        SGCN, SSSNET_node_clustering)
    from pytorch_geometric_signed_directed_tpu_torch.nn.signed.sgcn import (
        prepare_sgcn_inputs)
    from pytorch_geometric_signed_directed_tpu_torch.utils import (
        Prob_Balanced_Normalized_Loss, negative_sampling,
        structured_negative_sampling)

    gen = torch.Generator().manual_seed(0)
    if kind == "sssnet":
        (A_p, A_n), _ = SSBM(400, 3, 0.1, 0.1, size_ratio=1.5,
                             rng=np.random.default_rng(0))
        ops = []
        for A, fill in ((A_p.tocoo(), 0.5), (A_n.tocoo(), 0.0)):
            ops.append(rw_norm_propagator(np.vstack([A.row, A.col]), A.data,
                                          400, fill, mode="mxu",
                                          device=device))
        cut = Prob_Balanced_Normalized_Loss(A_p, A_n, mode="mxu",
                                            device=device)
        model = SSSNET_node_clustering(3, 16, 3, device=device,
                                       generator=gen)
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (400, 3)).astype(np.float32)).to(device)
        loss = cut(model(ops[0], ops[1], x)[3])
    else:
        rng = np.random.default_rng(2)
        n, m = 500, 4000
        es = np.column_stack([rng.integers(0, n, m), rng.integers(0, n, m),
                              np.where(rng.random(m) < 0.8, 1, -1)])
        emb = rng.standard_normal((n, 16)).astype(np.float32)
        pos, neg, emb, P, Q = prepare_sgcn_inputs(
            n, es, in_dim=16, init_emb=emb, mode="mxu",
            fused=kind == "sgcn fused", device=device)
        model = SGCN(n, in_dim=16, out_dim=16, init_emb=emb,
                     init_emb_grad=True, device=device, generator=gen)
        none = negative_sampling(np.concatenate([pos, neg], 1), n, rng=rng)
        loss = model.loss(P, Q, pos, neg, none,
                          structured_negative_sampling(pos, n, rng=rng),
                          structured_negative_sampling(neg, n, rng=rng))
    loss.backward()
    return [loss.detach()] + [p.grad for p in model.parameters()]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sssnet", "sgcn pair", "sgcn fused"])
def test_signed_models_on_card_match_the_cpu(card, kind):
    for a, b in zip(_signed_model_outputs(kind, card),
                    _signed_model_outputs(kind, "cpu")):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 17, 21, 34])
def test_scatter_sum_and_its_gradient_on_card(card, width):
    """K1 ``csr_scatter_sum`` at the attention widths (1 + F, 2 + 2F, and
    the motif backward's 1) through ``ops.scatter.scatter_sum``: one launch
    forward, the same bits twice, and the gather backward."""
    from pytorch_geometric_signed_directed_tpu_torch.ops import (
        build_scatter_plan, scatter_sum)

    rng = np.random.default_rng(width)
    rows = np.sort(rng.integers(0, 3000, 40000))
    rows = np.concatenate([rows, np.full(scatter_csr.PIECE_EDGES + 7, 3001)])
    plan = build_scatter_plan(rows, 3002, device=card)
    assert plan.split.rows.tolist() == [3001]               # a row is cut
    msgs = torch.randn(len(rows), width, device=card, requires_grad=True)
    before = scatter_csr.LAUNCHES["csr_scatter_sum"]
    out = scatter_sum(plan, msgs)
    assert scatter_csr.LAUNCHES["csr_scatter_sum"] == before + 1
    torch.testing.assert_close(
        out, scatter_csr.csr_scatter_sum_plain(plan.rowptr, msgs.detach()),
        **F32_TOL)
    assert torch.equal(out, scatter_sum(plan, msgs))
    g = torch.randn_like(out)
    (out * g).sum().backward()
    assert torch.equal(msgs.grad, g[plan.row_ids])


def _attention_model_outputs(kind, device):
    """Loss and every parameter gradient of a small SNEA (its loss), SiGAT
    or SDGNN (per-motif or fused) on ``device``, from one seed."""
    from pytorch_geometric_signed_directed_tpu_torch.nn import (
        SDGNN, SNEA, SiGAT)
    from pytorch_geometric_signed_directed_tpu_torch.nn.signed import (
        prepare_sdgnn_inputs, prepare_sigat_inputs, prepare_snea_inputs)
    from pytorch_geometric_signed_directed_tpu_torch.utils import (
        negative_sampling, structured_negative_sampling)

    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(3)
    n, m = 400, 3000
    es = np.column_stack([rng.integers(0, n, m), rng.integers(0, n, m),
                          np.where(rng.random(m) < 0.8, 1, -1)])
    emb = rng.standard_normal((n, 12)).astype(np.float32)
    fused = kind.endswith("fused")
    if kind == "snea":
        pos, neg, emb, graphs = prepare_snea_inputs(n, es, init_emb=emb,
                                                    device=device)
        model = SNEA(n, in_dim=12, out_dim=16, init_emb=emb, device=device,
                     generator=gen)
        none = negative_sampling(np.concatenate([pos, neg], 1), n, rng=rng)
        loss = model.loss(graphs, pos, neg, none,
                          structured_negative_sampling(pos, n, rng=rng),
                          structured_negative_sampling(neg, n, rng=rng))
    elif kind.startswith("sigat"):
        pos, neg, emb, graphs = prepare_sigat_inputs(
            n, es, init_emb=emb, fused=fused, device=device)
        model = SiGAT(n, in_dim=12, out_dim=10, init_emb=emb, fused=fused,
                      device=device, generator=gen)
        loss = model.loss(graphs, pos, neg)
    else:
        pos, neg, emb, graphs, w_pos, w_neg = prepare_sdgnn_inputs(
            n, es, init_emb=emb, fused=fused, device=device)
        model = SDGNN(n, in_dim=12, out_dim=10, init_emb=emb, fused=fused,
                      device=device, generator=gen)
        loss = model.loss(graphs, pos, neg, w_pos, w_neg)
    loss.backward()
    return [loss.detach()] + [p.grad for p in model.parameters()]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["snea", "sigat", "sigat fused", "sdgnn",
                                  "sdgnn fused"])
def test_attention_models_on_card_match_the_cpu(card, kind):
    before = scatter_csr.LAUNCHES["csr_scatter_sum"]
    outs = _attention_model_outputs(kind, card)
    assert scatter_csr.LAUNCHES["csr_scatter_sum"] > before
    for a, b in zip(outs, _attention_model_outputs(kind, "cpu")):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


def _gcn_graph(n=9000, e=60000, seed=5):
    rng = np.random.default_rng(seed)
    return np.vstack([rng.integers(0, n, e), rng.integers(0, n, e)]), n


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 64])
def test_k1_on_a_gcn_norm_propagator_on_card(card, width):
    """DiGCL's operator: ``gcn_norm_propagator(mode="auto")`` above 8,192
    nodes is the kernel tier; K1 at the encoder's widths against its plain
    version, the same bits twice, forward and transposed."""
    from pytorch_geometric_signed_directed_tpu_torch.graph import (
        gcn_norm_propagator)

    ei, n = _gcn_graph()
    P = gcn_norm_propagator(ei, None, n, mode="auto", device=card)
    assert P.mode == "mxu" and not P.csr.blocks
    for c in (P.csr, P.csr.transposed):
        x = torch.randn(n, width, device=card)
        args = (c.rowptr, c.col, c.val, c.val, x, width)
        got = scatter_csr.csr_dual_spmm(*args, c.row_split)
        torch.testing.assert_close(
            got, scatter_csr.csr_dual_spmm_plain(*args), **F32_TOL)
        assert torch.equal(got, scatter_csr.csr_dual_spmm(*args,
                                                          c.row_split))


def _digcl_step(device, batch_size):
    """Loss and every parameter gradient of one DiGCL step (the bench
    cell's model on two views of one operator) on ``device``."""
    from pytorch_geometric_signed_directed_tpu_torch.graph import (
        gcn_norm_propagator, in_out_degree)
    from pytorch_geometric_signed_directed_tpu_torch.nn import DiGCL

    ei, n = _gcn_graph()
    x = in_out_degree(ei, n)
    x = torch.from_numpy(x / x.max()).to(device)
    P = gcn_norm_propagator(ei, None, n, mode="auto", device=device)
    model = DiGCL(2, "relu", 64, 32, tau=0.4, num_layers=2, device=device,
                  generator=torch.Generator().manual_seed(0))
    loss = model.loss(model(x, P), model(0.9 * x, P),
                      batch_size=batch_size)
    loss.backward()
    return [loss.detach()] + [p.grad for p in model.parameters()]


@pytest.mark.cuda
@pytest.mark.parametrize("batch_size", [0, 2048])
def test_digcl_step_on_card_matches_the_cpu(card, batch_size):
    """8 K1 calls a step: 4 forward applies (W=128, 64 for each view) and
    their transposes in the backward; the batched loss recomputes its
    blocks in the backward."""
    before = scatter_csr.LAUNCHES["csr_dual_spmm"]
    outs = _digcl_step(card, batch_size)
    assert scatter_csr.LAUNCHES["csr_dual_spmm"] == before + 8
    for a, b in zip(outs, _digcl_step("cpu", batch_size)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


def _hub_inputs(device):
    """The kernel-tier Laplacian pair of a 3,000-node graph whose node 7
    has 2,000 in-edges, so its Laplacian row is cut into pieces; features,
    labels and masks from a seed."""
    from pytorch_geometric_signed_directed_tpu_torch.spectral import (
        magnet_propagators)

    n = 3000
    rng = np.random.default_rng(4)
    row = np.concatenate([rng.integers(0, n, 30_000),
                          rng.integers(8, n, 2000)])
    col = np.concatenate([rng.integers(0, n, 30_000), np.full(2000, 7)])
    keep = row != col
    ei = np.stack([row[keep], col[keep]])
    lap = magnet_propagators(ei, np.ones(ei.shape[1]), q=0.25, num_nodes=n,
                             mode="mxu", device=device)
    assert lap.dual.row_split.rows.numel() > 0       # a cut row
    x = torch.from_numpy(rng.random((n, 2)).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.integers(0, 3, n)).to(device)
    masks = torch.from_numpy(
        (rng.random((3, n)) < 0.3).astype(np.float32)).to(device)
    return lap, x, y, masks


def _hub_magnet(device, dropout=0.0):
    """MagNet (K=2, hidden 8) on ``_hub_inputs``."""
    from pytorch_geometric_signed_directed_tpu_torch.nn import (
        MagNet_node_classification)

    lap, x, y, masks = _hub_inputs(device)

    def apply_fn(model, training, generator):
        return model(x, x, lap, training, generator)

    def init():
        return MagNet_node_classification(
            num_features=2, hidden=8, K=2, label_dim=3, activation=True,
            layer=2, dropout=dropout, device=device,
            generator=torch.Generator().manual_seed(0))

    return apply_fn, init, y, masks


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_captured_epochs_match_eager_epochs_on_card(card, dropout):
    """A captured epoch replayed gives the eager loop's losses and
    selections bit for bit, with the same launches an epoch; with dropout
    the split's generator advances with each replay as it does eagerly."""
    from pytorch_geometric_signed_directed_tpu_torch.train import (
        SplitRun, adam)
    from pytorch_geometric_signed_directed_tpu_torch.train.scan_trainer \
        import split_generator

    apply_fn, init, y, masks = _hub_magnet(card, dropout)
    epochs = 12
    runs = []
    for captured in (False, True, True):
        gen = split_generator(0, 0, card) if dropout else None
        runs.append(SplitRun(apply_fn, init(), adam(1e-2, 5e-4), y, *masks,
                             epochs, gen).run(captured))
    eager, captured, again = runs
    torch.cuda.synchronize()
    assert captured.graph is not None and eager.graph is None
    per_epoch = {"csr_dual_spmm": 10}    # 4 + 2 transposed, 4 to evaluate
    assert eager.launches == {k: v * epochs for k, v in per_epoch.items()}
    assert captured.launches == captured.launches_per_replay == per_epoch
    for run in (captured, again):
        assert torch.equal(run.losses, eager.losses)
        assert torch.equal(run.results(), eager.results())


@pytest.mark.cuda
def test_replayed_spans_match_eager_spans_on_card(card):
    """With the port's spans on, a captured epoch's span table maps one
    replay's device operations onto the spans: the same kernels under
    each span, in the same order, as an eager epoch's operations matched
    to their launches through the profiler's correlation; the kernel
    wrapper spans number the launch counters' calls and hold K1."""
    from torch.profiler import ProfilerActivity, profile

    from pytorch_geometric_signed_directed_tpu_torch import instrument
    from pytorch_geometric_signed_directed_tpu_torch.train import (
        SplitRun, adam, profiling)
    from pytorch_geometric_signed_directed_tpu_torch.train.scan_trainer \
        import split_generator

    apply_fn, init, y, masks = _hub_magnet(card, 0.5)
    instrument.set_tracing(True)
    try:
        run = SplitRun(apply_fn, init(), adam(1e-2, 5e-4), y, *masks, 8,
                       split_generator(0, 0, card))
        run.capture()
        torch.cuda.synchronize()
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as eager:
            run.epoch()
            torch.cuda.synchronize()
        with profile(activities=acts) as replay:
            run.graph.replay()
            torch.cuda.synchronize()
    finally:
        instrument.set_tracing(False)
        instrument.drain()
    table = run.span_table
    assert table is not None and table.nodes > 0
    by_eager = profiling.attribute(eager)
    by_replay = profiling.attribute(replay, table)
    assert by_replay is not None and by_replay.replays == 1

    def kernels(att):
        out = {}
        for op in att.ops:
            if op.spans:
                out.setdefault(tuple(s.name for s in op.spans),
                               []).append(op.name)
        return out

    assert kernels(by_replay) == kernels(by_eager)
    names = [r.name for r in table.rows]
    assert names.count("spmm.apply") == 10
    assert names.count("kernel.csr_dual_spmm") == sum(
        run.launches_per_replay.values())
    assert all(op.innermost.name == "kernel.csr_dual_spmm"
               for op in by_replay.ops if "DualSource" in op.name)


def _trainable_q_magnet(device, sharded):
    """Trainable-q MagNet (K=2, hidden 8, q from 0.25) on the mxu template
    of a 3,000-node graph with a 2,000-edge hub row, flat or sharded on
    the one-card mesh; features, labels and masks from a seed."""
    from pytorch_geometric_signed_directed_tpu_torch.nn import (
        MagNet_node_classification)
    from pytorch_geometric_signed_directed_tpu_torch.parallel import (
        local_mesh, shard_magnet_laplacian)
    from pytorch_geometric_signed_directed_tpu_torch.spectral import (
        magnetic_template)

    n = 3000
    rng = np.random.default_rng(6)
    row = np.concatenate([rng.integers(0, n, 30_000),
                          rng.integers(8, n, 2000)])
    col = np.concatenate([rng.integers(0, n, 30_000), np.full(2000, 7)])
    tmpl = magnetic_template(np.stack([row, col]), None, num_nodes=n,
                             mode="mxu", device=device)
    if sharded:
        tmpl = shard_magnet_laplacian(tmpl, local_mesh(device))
    x = torch.from_numpy(rng.random((n, 2)).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.integers(0, 3, n)).to(device)
    masks = torch.from_numpy(
        (rng.random((3, n)) < 0.3).astype(np.float32)).to(device)

    def apply_fn(model, training, generator):
        return model(x, x, tmpl, training, generator)

    def init():
        return MagNet_node_classification(
            num_features=2, hidden=8, K=2, label_dim=3, activation=True,
            layer=2, trainable_q=True, device=device,
            generator=torch.Generator().manual_seed(0))

    return apply_fn, init, y, masks


@pytest.mark.cuda
@pytest.mark.parametrize("sharded", [False, True], ids=["flat", "sharded"])
def test_captured_trainable_q_epochs_match_eager_epochs_on_card(card,
                                                                sharded):
    """The trainable-q epoch captured and replayed: flat (K1's pair
    forward, K1 dx) and sharded (K1 a shard forward, K3 a shard
    backward, so K3 runs inside the graph); the eager loop's losses,
    selections and trained q bit for bit, the same launches an epoch, and
    the first eager epoch makes no host sync."""
    from pytorch_geometric_signed_directed_tpu_torch.train import (
        SplitRun, adam)

    apply_fn, init, y, masks = _trainable_q_magnet(card, sharded)
    epochs = 12
    first = SplitRun(apply_fn, init(), adam(1e-2, 5e-4), y, *masks, epochs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first.epoch()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    runs = [SplitRun(apply_fn, init(), adam(1e-2, 5e-4), y, *masks,
                     epochs).run(captured) for captured in (False, True, True)]
    eager, captured, again = runs
    torch.cuda.synchronize()
    assert captured.graph is not None and eager.graph is None
    # 2 layers of K=2 applies: forward and evaluation 4 each; flat dx for
    # the 3 applies whose input needs a gradient, sharded K3 for all 4
    per_epoch = ({"csr_dual_spmm": 8, "csr_dual_sddmm": 4} if sharded
                 else {"csr_pair_spmm": 8, "csr_dual_spmm": 3})
    assert eager.launches == {k: v * epochs for k, v in per_epoch.items()}
    assert captured.launches == captured.launches_per_replay == per_epoch
    q_eager = torch.cat([c.q.detach() for c in eager.model.convs])
    assert not torch.equal(q_eager, torch.full_like(q_eager, 0.25))
    for run in (captured, again):
        assert torch.equal(run.losses, eager.losses)
        assert torch.equal(run.results(), eager.results())
        assert torch.equal(torch.cat([c.q.detach()
                                      for c in run.model.convs]), q_eager)


@pytest.mark.cuda
def test_scan_node_training_captures_on_card(card):
    from pytorch_geometric_signed_directed_tpu_torch.train import (
        SplitRun, adam, scan_node_training)

    apply_fn, init, y, masks = _hub_magnet(card)
    got = scan_node_training(apply_fn, lambda s: init(), y.cpu().numpy(),
                             *(m[None].cpu().numpy() for m in masks),
                             epochs=8, tx=adam(1e-2, 5e-4))
    want = SplitRun(apply_fn, init(), adam(1e-2, 5e-4), y, *masks,
                    8).run(captured=False).results().cpu().numpy()
    np.testing.assert_array_equal(
        [got[k][0] for k in ("best_val", "best_test", "final_test",
                             "final_loss")], want)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["csr_dual_spmm", "csr_scatter_sum",
                                   "bsr_matmul"])
def test_wrapper_refuses_to_plan_under_capture_on_card(card, entry):
    rowptr, _ = hub_csr(card)
    nnz = int(rowptr[-1])
    col = torch.zeros(nnz, dtype=torch.int32, device=card)
    val = torch.ones(nnz, device=card)
    x = torch.randn(4, 8, device=card)
    msgs = torch.randn(nnz, 8, device=card)
    # made before the capture: a copy from the host is refused under it
    block_rowptr = torch.tensor([0, 1], dtype=torch.int32, device=card)
    blocks = torch.randn(1, 128, 128, device=card)
    x_bsr = torch.randn(128, 8, device=card)
    call = {
        "csr_dual_spmm": lambda: scatter_csr.csr_dual_spmm(
            rowptr, col, val, val, x, 4),
        "csr_scatter_sum": lambda: scatter_csr.csr_scatter_sum(rowptr, msgs),
        "bsr_matmul": lambda: bsr_spmm.bsr_matmul(
            blocks, block_rowptr, col[:1], x_bsr, 128)}[entry]
    call()                                  # eager: plans, with a sync
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="no plan"):
        with torch.cuda.graph(graph):
            call()


# --- the sharded paths: four shards on one card ------------------------------

def four_shards(card):
    from pytorch_geometric_signed_directed_tpu_torch import parallel

    return parallel.Mesh((card,) * 4)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [17, 34])
def test_scatter_sum_per_shard_on_card(card, width):
    """K1 ``csr_scatter_sum`` on each shard's CSR of a four-shard mesh
    (N=1000: rows_per 250; destinations below 600, so shard 3 has no
    edge and its rowptr is all zeros) against the plain version, the
    same bits twice; then the sharded apply against the flat one."""
    from pytorch_geometric_signed_directed_tpu_torch import parallel
    from pytorch_geometric_signed_directed_tpu_torch.nn.signed import (
        snea_conv)

    rng = np.random.default_rng(width)
    n = 1000
    ei = np.vstack([rng.integers(0, n, 20000), rng.integers(0, 600, 20000)])
    ei[1, :3000] = 7                                    # a row to cut
    g = snea_conv.build_attention_graph([(ei, 0, False)], n, device=card)
    sg = parallel.shard_attention_graph(g, four_shards(card))
    sizes = [sh.src.numel() for sh in sg.shards]
    assert sizes[3] == 0 and min(sizes[:3]) > 0
    for sh in sg.shards:
        p = sh.plan
        msgs = torch.randn(p.row_ids.numel(), width, device=card)
        before = scatter_csr.LAUNCHES["csr_scatter_sum"]
        got = scatter_csr.csr_scatter_sum(p.rowptr, msgs, p.split)
        assert scatter_csr.LAUNCHES["csr_scatter_sum"] == before + 1
        torch.testing.assert_close(
            got, scatter_csr.csr_scatter_sum_plain(p.rowptr, msgs),
            **F32_TOL)
        assert torch.equal(got, scatter_csr.csr_scatter_sum(
            p.rowptr, msgs, p.split))
        if not msgs.shape[0]:
            assert got.shape == (250, width) and not got.any()
    x = torch.randn(n, width, device=card)
    w = torch.randn(width, device=card)
    flat = snea_conv.attention_softmax_aggregate(g, x[g.src] @ w, x[g.src])
    before = scatter_csr.LAUNCHES["csr_scatter_sum"]
    out = parallel.sharded_attention_apply(
        sg, lambda s, d, ep, valid: (x[s] @ w, x[s]))
    assert scatter_csr.LAUNCHES["csr_scatter_sum"] == before + 4
    torch.testing.assert_close(out, flat, **F32_TOL)
    assert not out[750:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2, 32])
def test_bsr_per_shard_on_card(card, width):
    """K5 on each shard of a four-shard bsr operator (N=1000: 8 block rows,
    2 a shard, with their own plans) against the plain version, the same
    bits twice; the sharded apply and its backward (K5 on the transposed
    partition) against the flat operator."""
    from pytorch_geometric_signed_directed_tpu_torch import parallel

    rng = np.random.default_rng(width)
    n = 1000
    ei = np.vstack([rng.integers(0, n, 8000), rng.integers(0, 700, 8000)])
    P = spmm.make_propagator(ei[0], ei[1], None, n, mode="bsr", device=card)
    S = parallel.shard_propagator(P, four_shards(card))
    assert S.mode == "bsr"
    x = torch.randn(n, width, device=card)
    for b in S.sharded.shards + S.sharded.transposed.shards:
        got = bsr_spmm.bsr_matmul(b.blocks, b.block_rowptr, b.block_cols, x,
                                  b.num_rows, b.split)
        torch.testing.assert_close(
            got, bsr_spmm.bsr_matmul_plain(b.blocks, b.block_rowptr,
                                           b.block_cols, x, b.num_rows),
            **F32_TOL)
        assert torch.equal(got, bsr_spmm.bsr_matmul(
            b.blocks, b.block_rowptr, b.block_cols, x, b.num_rows, b.split))
    xs = x.clone().requires_grad_(True)
    before = bsr_spmm.LAUNCHES["bsr_spmm"]
    out = S(xs)
    (out ** 2).sum().backward()
    assert bsr_spmm.LAUNCHES["bsr_spmm"] == before + 8
    xf = x.clone().requires_grad_(True)
    ref = P(xf)
    (ref ** 2).sum().backward()
    torch.testing.assert_close(out, ref, **F32_TOL)
    torch.testing.assert_close(xs.grad, xf.grad, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_sharded_snea_forward_on_card(card):
    """SNEA on attention graphs sharded four ways on one card: the forward
    against the flat one (each shard shifts by its own largest logit, so
    they agree to rounding), and 4 ``csr_scatter_sum`` a shard and
    forward (two attends in each layer: no fused pair on a sharded
    g_cat)."""
    from pytorch_geometric_signed_directed_tpu_torch import parallel
    from pytorch_geometric_signed_directed_tpu_torch.nn import SNEA
    from pytorch_geometric_signed_directed_tpu_torch.nn.signed import (
        snea_graphs)

    rng = np.random.default_rng(0)
    n = 2000
    pos = np.vstack([rng.integers(0, n, 20000), rng.integers(0, n, 20000)])
    neg = np.vstack([rng.integers(0, n, 5000), rng.integers(0, n, 5000)])
    emb = rng.standard_normal((n, 32)).astype(np.float32)
    graphs = snea_graphs(pos, neg, n, device=card)
    sgraphs = parallel.shard_attention_graphs(graphs, four_shards(card))
    model = SNEA(n, in_dim=32, out_dim=32, init_emb=emb, device=card,
                 generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        flat = model(graphs)
        before = scatter_csr.LAUNCHES["csr_scatter_sum"]
        out = model(sgraphs)
        assert scatter_csr.LAUNCHES["csr_scatter_sum"] == before + 4 * 4
    torch.testing.assert_close(out, flat, rtol=1e-4, atol=1e-5)


# --- row blocks: short rows and widths off a multiple of 4 -------------------

SHORT_KINDS = ("one_edge", "power_law", "empty", "block_length", "hub")


def short_row_csr(kind, seed, device):
    """A CSR for the kernels' row blocks: one-edge rows; 2-4-edge
    power-law rows; rows of which half are empty; rows of BLOCK_EDGES
    edges and one more beside short ones; or a hub row (cut into pieces)
    beside one- and two-edge rows.  Returns rowptr, its plan and the row
    lengths."""
    rng = np.random.default_rng(seed)
    T = scatter_csr.BLOCK_EDGES
    n = 20_000
    if kind == "one_edge":
        lengths = np.ones(n, np.int64)
    elif kind == "power_law":
        lengths = np.minimum(rng.zipf(2.0, n) + 1, 4)
        lengths[rng.random(n) < 0.1] = 0
    elif kind == "empty":
        lengths = rng.integers(0, 2, n) * rng.integers(1, 4, n)
    elif kind == "block_length":
        lengths = np.tile([T, T + 1, 1, 0, T // 2, T // 2 + 1, 2], n // 7)
    else:
        lengths = np.concatenate([rng.integers(1, 3, n // 2), [200_000],
                                  rng.integers(1, 3, n // 2)])
    rowptr = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(lengths)]).astype(np.int32)).to(device)
    split = scatter_csr.plan_row_split(rowptr)
    assert split.blocks.shape[0] > 0
    return rowptr, split, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("accum", [False, True], ids=["plain", "accum"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width", [1, 5, 10, 32, 64])
@pytest.mark.parametrize("kind", SHORT_KINDS)
def test_dual_on_short_row_blocks_on_card(card, kind, width, dtype, accum):
    """K1 and K2 (``csr_dual_spmm[_accum]``) on CSRs of short rows, which
    the kernel sums by row block: against the plain version, the same
    bits twice, rows without edges 0 (plain) or untouched (accumulate)."""
    mdt = torch.float32 if dtype == "f32" else torch.bfloat16
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    rowptr, split, lengths = short_row_csr(kind, width, card)
    n, e, m = len(lengths), int(lengths.sum()), 5000
    gen = torch.Generator(device=card).manual_seed(width)
    col = torch.randint(0, m, (e,), generator=gen, device=card,
                        dtype=torch.int32)
    va, vb = torch.randn(2, e, generator=gen, device=card)
    x = torch.randn(m, width, generator=gen, device=card).to(mdt)
    args = (rowptr, col, va, vb, x, width // 2)
    empty = torch.from_numpy(lengths == 0).to(card)
    if accum:
        row0 = 3
        out0 = torch.randn(n + 7, width, generator=gen, device=card)
        got = scatter_csr.csr_dual_spmm_accum(*args, out0.clone(), row0,
                                              split)
        want = scatter_csr.csr_dual_spmm_accum_plain(*args, out0, row0)
        again = scatter_csr.csr_dual_spmm_accum(*args, out0.clone(), row0,
                                                split)
        inner = slice(row0, row0 + n)
        assert torch.equal(got[inner][empty], out0[inner][empty])
        assert torch.equal(got[:row0], out0[:row0])
        assert torch.equal(got[row0 + n:], out0[row0 + n:])
    else:
        got = scatter_csr.csr_dual_spmm(*args, split)
        want = scatter_csr.csr_dual_spmm_plain(*args)
        again = scatter_csr.csr_dual_spmm(*args, split)
        assert torch.all(got[empty] == 0)
    torch.testing.assert_close(got, want, **tol)
    assert torch.equal(got, again)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width", list(range(1, 41)) + [128])
def test_scatter_at_every_width_on_card(card, width, dtype):
    """K1 ``csr_scatter_sum`` and K2 ``csr_scatter_accum`` at widths 1-40
    and 128 on power-law short rows beside rows around the block length
    and a hub row cut into pieces, with message rows that start 16-byte
    aligned and a base that does not: against the plain version, the
    same bits twice, rows without edges 0 or untouched."""
    mdt = torch.float32 if dtype == "f32" else torch.bfloat16
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    rng = np.random.default_rng(width)
    T = scatter_csr.BLOCK_EDGES
    lengths = np.concatenate([
        np.minimum(rng.zipf(2.0, 3000), 6) * (rng.random(3000) > 0.1),
        [T, T + 1, 3000, 0, 200, 1]])
    rowptr = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(lengths)]).astype(np.int32)).to(card)
    split = scatter_csr.plan_row_split(rowptr)
    n, e = len(lengths), int(lengths.sum())
    empty = torch.from_numpy(lengths == 0).to(card)
    gen = torch.Generator(device=card).manual_seed(width)
    flat = torch.randn(e * width + 3, generator=gen, device=card).to(mdt)
    aligned = flat[:e * width].view(e, width)
    shifted = flat[3:].view(e, width)
    assert shifted.data_ptr() % 16 != 0
    out0 = torch.randn(n + 2, width, generator=gen, device=card)
    for msgs in (aligned, shifted):
        got = scatter_csr.csr_scatter_sum(rowptr, msgs, split)
        torch.testing.assert_close(
            got, scatter_csr.csr_scatter_sum_plain(rowptr, msgs), **tol)
        assert torch.equal(got, scatter_csr.csr_scatter_sum(rowptr, msgs,
                                                            split))
        assert torch.all(got[empty] == 0)
        acc = scatter_csr.csr_scatter_accum(rowptr, msgs, out0.clone(), 1,
                                            split)
        torch.testing.assert_close(
            acc, scatter_csr.csr_scatter_accum_plain(rowptr, msgs, out0, 1),
            **tol)
        assert torch.equal(acc[1:n + 1][empty], out0[1:n + 1][empty])
        assert torch.equal(acc, scatter_csr.csr_scatter_accum(
            rowptr, msgs, out0.clone(), 1, split))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width", [1, 5, 17, 21, 34, 64, 65])
def test_scatter_on_long_uncut_rows_on_card(card, width, dtype):
    """``csr_scatter_sum`` and ``csr_scatter_accum`` on uncut rows of 40
    to 1,024 edges (at V = 1 a warp walks each row past 64 edges) among
    power-law short rows, message rows aligned and from a base off 16
    bytes: against the plain version, the same bits twice."""
    mdt = torch.float32 if dtype == "f32" else torch.bfloat16
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    rng = np.random.default_rng(width)
    lengths = np.concatenate([
        np.exp(rng.uniform(np.log(40), np.log(1024), 400)).astype(np.int64),
        [63, 64, 65, 1024], np.minimum(rng.zipf(2.0, 1200), 39)])
    lengths = lengths[rng.permutation(len(lengths))]
    rowptr = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(lengths)]).astype(np.int32)).to(card)
    split = scatter_csr.plan_row_split(rowptr)
    assert split.rows.numel() == 0
    n, e = len(lengths), int(lengths.sum())
    gen = torch.Generator(device=card).manual_seed(width)
    flat = torch.randn(e * width + 1, generator=gen, device=card).to(mdt)
    out0 = torch.randn(n, width, generator=gen, device=card)
    for msgs in (flat[:e * width].view(e, width), flat[1:].view(e, width)):
        got = scatter_csr.csr_scatter_sum(rowptr, msgs, split)
        torch.testing.assert_close(
            got, scatter_csr.csr_scatter_sum_plain(rowptr, msgs), **tol)
        assert torch.equal(got, scatter_csr.csr_scatter_sum(rowptr, msgs,
                                                            split))
        acc = scatter_csr.csr_scatter_accum(rowptr, msgs, out0.clone(), 0,
                                            split)
        torch.testing.assert_close(
            acc, scatter_csr.csr_scatter_accum_plain(rowptr, msgs, out0),
            **tol)
        assert torch.equal(acc, scatter_csr.csr_scatter_accum(
            rowptr, msgs, out0.clone(), 0, split))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", ["walked", "tiled"])
@pytest.mark.parametrize("accum", [False, True], ids=["plain", "accum"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width", [33, 48, 96, 128, 300])
@pytest.mark.parametrize("kind", SHORT_KINDS)
def test_dual_on_wide_row_blocks_on_card(card, kind, width, dtype, accum,
                                         blocks, monkeypatch):
    """K1 and K2 above 32 lanes, the row blocks walked a warp a row (x
    within the L2 rule) or taken in tiles of 32 lanes a warp (the rule
    set to 0, as for an x far larger than L2), the walk's lanes as one
    vector a thread (48, 96, 128) or strided one by one (33, 300, and x
    from a base off the vector's alignment): against the plain version,
    the same bits twice, rows without edges 0 (plain) or untouched
    (accumulate).
    A cut hub row is held at 1e-4, as chip_smoke.py and
    scripts/ab_kernel_variants.py hold it: its compensated float32 pieces
    lie ~1e-5 of its sums from float64, which F32_TOL misses where a lane
    of the row cancels to near 0 (at 300 lanes, 2.9e-5 at a value of 0.63
    on an H100, the parent's arithmetic on pieces)."""
    if blocks == "tiled":
        monkeypatch.setattr(scatter_csr, "WIDE_BLOCK_L2", 0)
    mdt = torch.float32 if dtype == "f32" else torch.bfloat16
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    rowptr, split, lengths = short_row_csr(kind, width, card)
    cut = torch.zeros(len(lengths), dtype=torch.bool, device=card)
    cut[split.rows.long()] = True
    n, e, m = len(lengths), int(lengths.sum()), 5000
    gen = torch.Generator(device=card).manual_seed(width)
    col = torch.randint(0, m, (e,), generator=gen, device=card,
                        dtype=torch.int32)
    va, vb = torch.randn(2, e, generator=gen, device=card)
    flat = torch.randn(m * width + 1, generator=gen, device=card).to(mdt)
    empty = torch.from_numpy(lengths == 0).to(card)
    for x in (flat[:m * width].view(m, width), flat[1:].view(m, width)):
        args = (rowptr, col, va, vb, x, width // 3)
        if accum:
            row0 = 3
            out0 = torch.randn(n + 7, width, generator=gen, device=card)
            got = scatter_csr.csr_dual_spmm_accum(*args, out0.clone(), row0,
                                                  split)
            want = scatter_csr.csr_dual_spmm_accum_plain(*args, out0, row0)
            again = scatter_csr.csr_dual_spmm_accum(*args, out0.clone(),
                                                    row0, split)
            inner = slice(row0, row0 + n)
            assert torch.equal(got[inner][empty], out0[inner][empty])
            assert torch.equal(got[:row0], out0[:row0])
            assert torch.equal(got[row0 + n:], out0[row0 + n:])
            got, want, again = got[inner], want[inner], again[inner]
        else:
            got = scatter_csr.csr_dual_spmm(*args, split)
            want = scatter_csr.csr_dual_spmm_plain(*args)
            again = scatter_csr.csr_dual_spmm(*args, split)
            assert torch.all(got[empty] == 0)
        torch.testing.assert_close(got[~cut], want[~cut], **tol)
        torch.testing.assert_close(got[cut], want[cut], rtol=1e-4,
                                   atol=1e-4)
        assert torch.equal(got, again)
    torch.cuda.synchronize()


# --- MagNetConv's complex epilogue -------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "shifted"])
@pytest.mark.parametrize("width", [1, 5, 64, 130])
def test_complex_epilogue_matches_plain_on_card(card, width, aligned):
    """The epilogue kernel, forward and backward, against its plain
    version: the same bits for z, the mask and the gradient of [o1 | o2],
    the bias gradient (float64 sums in other orders) to float32 rounding;
    rows off a multiple of the CTA's, widths off a multiple of 4, rows
    that do not start 16-byte aligned, and re = 0 exactly."""
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        complex_epilogue as epi)

    n, f = 2 * 1056 * 16 + 37, width
    gen = torch.Generator(device=card).manual_seed(width)

    def lane_stacked():
        buf = torch.randn(n * 2 * f + 1, device=card, generator=gen)
        return (buf[:-1] if aligned else buf[1:]).view(n, 2 * f)

    y, dz = lane_stacked(), lane_stacked()
    y[: n // 3, :f] = y[: n // 3, f:]          # re = 0 where there is no bias
    for bias in (None, torch.randn(f, device=card, generator=gen)):
        for act in (True, False):
            before = dict(epi.LAUNCHES)
            z, mask = epi.complex_epilogue(y, bias, act)
            want, want_mask = epi.complex_epilogue_plain(y, bias, act)
            assert torch.equal(z, want)
            assert (mask is None and want_mask is None) or torch.equal(
                mask, want_mask)
            uv, db = epi.complex_epilogue_backward(dz, mask, bias is not None)
            want_uv, want_db = epi.complex_epilogue_backward_plain(
                dz, mask, bias is not None)
            assert torch.equal(uv, want_uv)
            if bias is None:
                assert db is None
            else:
                torch.testing.assert_close(db, want_db, rtol=1e-6, atol=1e-5)
                assert torch.equal(db, epi.complex_epilogue_backward(
                    dz, mask, True)[1])                 # no atomics
            assert epi.LAUNCHES["complex_epilogue"] == (
                before["complex_epilogue"] + 1)
    assert epi.complex_epilogue(y, None, True)[1][: n // 3].all()
    assert not set(epi.LAUNCHES) & set(cuda_launch_counts())
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_complex_epilogue_takes_float64_plain_on_card(card):
    """A float64 model on the card (a reference run) takes the plain
    versions: the kernel is float32, and launches nothing."""
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        complex_epilogue as epi)

    gen = torch.Generator(device=card).manual_seed(0)
    y = torch.randn(100, 10, device=card, generator=gen, dtype=torch.float64)
    bias = torch.randn(5, device=card, generator=gen, dtype=torch.float64)
    before = dict(epi.LAUNCHES)
    z, mask = epi.complex_epilogue(y, bias, True)
    want, want_mask = epi.complex_epilogue_plain(y, bias, True)
    assert torch.equal(z, want) and torch.equal(mask, want_mask)
    uv, db = epi.complex_epilogue_backward(y, mask, True)
    want_uv, want_db = epi.complex_epilogue_backward_plain(y, mask, True)
    assert torch.equal(uv, want_uv) and torch.equal(db, want_db)
    assert uv.dtype == db.dtype == torch.float64
    assert epi.LAUNCHES == before


def cuda_launch_counts():
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        launch_counts)
    return launch_counts()


@pytest.mark.cuda
def test_fused_magnet_matches_generic_on_card(card):
    """MagNet on the kernel tier of the hub graph: the fused layers (one
    epilogue launch a layer, forward and backward) against the same
    operators without the dual, the generic recurrence, in the loss and
    every gradient."""
    from pytorch_geometric_signed_directed_tpu_torch.nn.directed import (
        magnet_conv)
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        complex_epilogue as epi)
    from pytorch_geometric_signed_directed_tpu_torch.spectral import (
        MagneticPair)

    _, init, _, _ = _hub_magnet(card)
    lap, x, y, masks = _hub_inputs(card)
    unfused = MagneticPair(lap.re, lap.im, None)
    results = []
    for pair in (lap, unfused):
        model = init()
        reset_counts()
        logp = model(x, x, pair)
        loss = -(logp[torch.arange(len(y), device=card), y] * masks[0]).sum()
        loss.backward()
        torch.cuda.synchronize()
        fused = pair is lap
        assert magnet_conv.FUSED_CALLS == (
            {"forward": 2, "backward": 2} if fused
            else {"forward": 0, "backward": 0})
        assert epi.LAUNCHES == (
            {"complex_epilogue": 2, "complex_epilogue_backward": 2} if fused
            else {"complex_epilogue": 0, "complex_epilogue_backward": 0})
        results.append([logp.detach()] + [p.grad for p in model.parameters()])
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=2e-6 * float(b.abs().max()))


@pytest.mark.cuda
def test_range_finder_on_the_card_spans_the_numpys_subspace(card):
    """The spectral features' randomized SVD run on the card (float64
    torch sparse products and LU) against the numpy one from the same
    start: the card twin of ``test_torch_sdgnn_cell``'s CPU test."""
    import scipy.linalg
    import scipy.sparse as sp

    from pytorch_geometric_signed_directed_tpu_torch.spectral import (
        features)

    rng = np.random.default_rng(0)
    M = sp.random(400, 400, density=0.02, random_state=0, format="csr")
    M = sp.csr_matrix(M + M.T)
    M.data = np.sign(rng.standard_normal(M.nnz))
    want = features.randomized_svd_components(M, 16, random_state=4)
    got = features.randomized_svd_components(M, 16, random_state=4,
                                             device=card)
    assert got.device.type == "cuda" and got.dtype == torch.float64
    angles = scipy.linalg.subspace_angles(want.T, got.cpu().numpy().T)
    assert angles.max() < 1e-8


@pytest.mark.cuda
def test_spectral_features_on_the_card_at_epinions_size(card):
    """``create_spectral_features`` at the SDGNN cell's size (the
    ``epinions_signed`` traffic at seed 0: 131,580 nodes, 711,210 signed
    pairs, width 32) on the card against the host's (about a minute of
    numpy): the same subspace at float32 output."""
    import json
    import os
    import time

    import scipy.linalg

    from port_bench.gen import signed_powerlaw
    from pytorch_geometric_signed_directed_tpu_torch.nn.signed.sgcn import (
        split_signed_edges)
    from pytorch_geometric_signed_directed_tpu_torch.spectral import (
        features)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "port_bench", "traffic",
                           "epinions_signed.json")) as f:
        g = signed_powerlaw.generate(json.load(f), 0, device=card)
    pos, neg = split_signed_edges(
        np.vstack([g["edge_index"], g["edge_sign"]]).T)
    n = g["num_nodes"]
    seconds = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = features.create_spectral_features(pos, neg, n, 32, seed=5,
                                                device=card)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    want = features.create_spectral_features(pos, neg, n, 32, seed=5)
    angles = scipy.linalg.subspace_angles(
        want.astype(np.float64), got.cpu().numpy().astype(np.float64))
    print(f"card seconds {seconds}, largest principal angle "
          f"{angles.max():.3e}")
    assert got.shape == (n, 32) and got.dtype == torch.float32
    assert angles.max() < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("width", [8, 32, 33])
def test_gather_rows_backward_on_the_card(card, width):
    """``ops.scatter.gather_rows`` on the card: the forward is the
    indexing's bits; the backward (K1 over the positions sorted by row,
    a hub of 5,000 gathers cut into pieces) equals the float64 sum of
    the gradient rows at float32 rounding, and twice the same bits."""
    from pytorch_geometric_signed_directed_tpu_torch.ops.scatter import (
        build_gather_plan, gather_rows)

    rng = np.random.default_rng(width)
    n = 20000
    index = rng.permutation(np.concatenate(
        [rng.integers(0, n, 200000), np.full(5000, 11)]))
    gp = build_gather_plan(index, n, device=card)
    assert gp.plan.split.rows.numel() >= 1
    table = torch.tensor(rng.standard_normal((n, width)), dtype=torch.float32,
                         device=card, requires_grad=True)
    g = torch.tensor(rng.standard_normal((len(index), width)),
                     dtype=torch.float32, device=card)
    grads = []
    for _ in range(2):
        table.grad = None
        out = gather_rows(table, gp)
        assert torch.equal(out, table.detach()[gp.index])
        (out * g).sum().backward()
        grads.append(table.grad.clone())
    assert torch.equal(grads[0], grads[1])
    want = torch.zeros(n, width, dtype=torch.float64, device=card
                       ).index_add_(0, gp.index, g.double())
    torch.testing.assert_close(grads[0].double(), want, rtol=1e-5,
                               atol=1e-5)


def _indexed_case(card, f, seed):
    """A CSR of 5,000 rows (every odd row empty, the others ~25 edges)
    with hub rows of 3,000 + 25 and PIECE_EDGES + 1 edges (cut), rows of
    WALK_EDGES, WALK_EDGES + 1, 200 and PIECE_EDGES edges (the last three
    walked), a table of 7,000 rows of ``f`` lanes, and per-edge indices,
    weights and scalars."""
    from pytorch_geometric_signed_directed_tpu_torch.ops import (
        build_scatter_plan)

    rng = np.random.default_rng(seed)
    long_rows = {4802: scatter_csr.WALK_EDGES,
                 4804: scatter_csr.WALK_EDGES + 1, 4806: 200,
                 4808: scatter_csr.PIECE_EDGES,
                 4810: scatter_csr.PIECE_EDGES + 1}
    rows = np.sort(np.concatenate(
        [rng.integers(0, 2400, 60000) * 2, np.full(3000, 10)]
        + [np.full(k, r) for r, k in long_rows.items()]))
    plan = build_scatter_plan(rows, 5000, device=card)
    assert plan.split.rows.tolist() == [10, 4810]
    assert plan.split.walks.tolist() == [4804, 4806, 4808]
    e, m = len(rows), 7000
    table = torch.randn(m, f, device=card)
    index = torch.from_numpy(rng.integers(0, m, e)).to(card)
    w, s = torch.randn(e, device=card), torch.randn(e, device=card)
    return plan, table, index, w, s


@pytest.mark.cuda
@pytest.mark.parametrize("scalar", ["none", "scalar", "scalar, no weight",
                                    "no weight"])
@pytest.mark.parametrize("f", [32, 20, 21])
def test_indexed_scatter_sum_is_k1_over_its_messages_on_card(card, f,
                                                             scalar):
    """K1 reading its messages by index against K1 over the materialized
    messages at the same geometry, bit for bit: at F % 4 == 0 the row
    lanes against the [E, F] messages w * table[index], the scalar lane
    against lane 0 of those messages with s in place of lane 0 (the
    scalar is summed as lane 0 is); at F = 21 (V = 1) against the
    [E, F + 1] messages themselves; all against the float64 plain
    version.  Hub rows cut into pieces, walked rows, empty rows; one
    launch counted in both keys; the same bits twice."""
    plan, table, index, w, s = _indexed_case(card, f, f)
    weighted = "no weight" not in scalar
    kw = dict(index=index, weight=w) if weighted else dict(index=index)
    if scalar.startswith("scalar"):
        kw["scalar"] = s
    before = dict(scatter_csr.LAUNCHES)
    got = scatter_csr.csr_scatter_sum(plan.rowptr, table, plan.split, **kw)
    assert scatter_csr.LAUNCHES["csr_scatter_sum"] == \
        before["csr_scatter_sum"] + 1
    assert scatter_csr.LAUNCHES["csr_scatter_sum_indexed"] == \
        before["csr_scatter_sum_indexed"] + 1
    msgs = scatter_csr.indexed_messages(table, **kw)
    torch.testing.assert_close(
        got, scatter_csr.csr_scatter_sum_plain(plan.rowptr, msgs), **F32_TOL)
    assert torch.all(got[1::2] == 0)
    assert torch.equal(got, scatter_csr.csr_scatter_sum(
        plan.rowptr, table, plan.split, **kw))
    if f % 4:
        assert scatter_csr._msg_geometry(table)[0] == 1
        assert torch.equal(got, scatter_csr.csr_scatter_sum(
            plan.rowptr, msgs, plan.split))
        return
    rows_ = table[index] * (w[:, None] if weighted else 1)
    lanes = scatter_csr.csr_scatter_sum(plan.rowptr, rows_, plan.split)
    off = 1 if "scalar" in kw else 0
    assert torch.equal(got[:, off:off + f], lanes)
    if "scalar" in kw:
        lane0 = rows_.clone()
        lane0[:, 0] = s
        want = scatter_csr.csr_scatter_sum(plan.rowptr, lane0, plan.split)
        assert torch.equal(got[:, 0], want[:, 0])


@pytest.mark.cuda
def test_indexed_scatter_sum_of_an_unaligned_table_on_card(card):
    """A table whose rows do not start 16-byte aligned takes the V = 1
    walks: the bits of K1 over the materialized messages."""
    plan, table, index, w, s = _indexed_case(card, 33, 5)
    shifted = torch.randn(table.numel() + 1, device=card)[1:].view(
        table.shape)
    kw = dict(index=index, weight=w, scalar=s)
    got = scatter_csr.csr_scatter_sum(plan.rowptr, shifted, plan.split, **kw)
    msgs = scatter_csr.indexed_messages(shifted, **kw)
    assert torch.equal(got, scatter_csr.csr_scatter_sum(plan.rowptr, msgs,
                                                        plan.split))


@pytest.mark.cuda
@pytest.mark.parametrize("f", [32, 20, 7])
def test_attend_logit_grad_matches_plain_on_card(card, f):
    """The edge kernel against its plain version (which sums an edge's
    products in float32, the kernel in float64), edges of a hub of 5,000
    into one destination among them; the same bits twice."""
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        attend_grad)

    rng = np.random.default_rng(f)
    n, e = 4000, 60000
    row = torch.from_numpy(np.sort(np.concatenate([
        rng.integers(0, n, e - 5000), np.full(5000, 17)]))).to(card)
    index = torch.from_numpy(rng.integers(0, n, e)).to(card)
    T, out, dout = (torch.randn(n, f, device=card) for _ in range(3))
    alpha = torch.rand(e, device=card)
    pre = torch.randn(e, device=card)
    args = (row, index, T, out, dout, alpha, pre, 0.2)
    before = attend_grad.LAUNCHES["attend_logit_grad"]
    got = attend_grad.attend_logit_grad(*args)
    assert attend_grad.LAUNCHES["attend_logit_grad"] == before + 1
    want = attend_grad.attend_logit_grad_plain(
        *(a.double() if a.is_floating_point() else a for a in args[:-1]),
        0.2)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, attend_grad.attend_logit_grad(*args))


@pytest.mark.cuda
def test_motif_attend_on_card_matches_the_composition_it_replaces(card):
    """``motif_attend`` forward and backward on the card (indexed K1 and
    the edge kernel) against the composition it replaced, run on the
    card: the gathered [E, F] messages, their concatenation and reorder,
    and K1 over them, at a size whose hub destinations and sources are cut
    into pieces.  The calls: one K1 forward, two backward (both indexed
    but the W = 1 sum by destination), one edge kernel."""
    from pytorch_geometric_signed_directed_tpu_torch.nn.signed import (
        motif_stack)
    from pytorch_geometric_signed_directed_tpu_torch.nn.signed.snea_conv \
        import _global_shift
    from pytorch_geometric_signed_directed_tpu_torch.ops import scatter_sum
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        launch_counts)

    rng = np.random.default_rng(7)
    n, f, G = 20000, 32, 4
    lists = []
    for g in range(G):
        src = np.concatenate([rng.integers(0, n, 60000), np.full(3000, g),
                              rng.integers(0, n, 2500)])
        dst = np.concatenate([rng.integers(0, n, 60000),
                              rng.integers(0, n, 3000), np.full(2500, 5)])
        lists.append(np.vstack([src, dst]))
    ms = motif_stack.build_motif_stack(lists, n, device=card)
    assert ms.g.plan.split.rows.numel() >= G
    assert ms.src_plan.split.rows.numel() >= G
    GN, slope = G * n, 0.2
    T0, a0, b0 = (torch.randn(GN, f, device=card), torch.randn(GN, device=card),
                  torch.randn(GN, device=card))
    gout = torch.randn(GN, f, device=card)

    def composed(T, a_src, a_dst):
        g = ms.g
        pre = a_src[g.src] + a_dst[g.dst]
        logit = torch.where(pre >= 0, pre, slope * pre)
        ex = torch.exp(logit - _global_shift(logit))
        msgs = torch.cat([ex[:, None], T[g.src] * ex[:, None]], 1)
        agg = scatter_sum(g.plan, msgs)
        S = agg[:, :1].clamp_min(torch.finfo(T.dtype).tiny)
        return agg[:, 1:] / S

    ins = [v.clone().requires_grad_(True) for v in (T0, a0, b0)]
    before = launch_counts()
    out = motif_stack.motif_attend(slope, ms, *ins)
    (out * gout).sum().backward()
    counted = {k: v - before[k] for k, v in launch_counts().items()
               if v != before[k]}
    assert counted == {"csr_scatter_sum": 3, "csr_scatter_sum_indexed": 2,
                       "attend_logit_grad": 1}
    # the composition's backward by autograd: K1's gather backward and the
    # indexing's own
    ref = [v.clone().requires_grad_(True) for v in (T0, a0, b0)]
    want = composed(*ref)
    (want * gout).sum().backward()
    torch.testing.assert_close(out, want, **F32_TOL)
    for a, b, name in zip(ins, ref, ("T", "a_src", "a_dst")):
        scale = float(b.grad.abs().max())
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4,
                                   atol=1e-5 * scale, msg=name)
