"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card (a CUDA kernel has no CPU mode) and skip
without one.  This file imports neither JAX nor the tests' conftest, so
on a machine with a card it runs as

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

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
        scatter_csr.reset_launch_counts()
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
        launch_counts, reset_launch_counts)
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
        reset_launch_counts()
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
