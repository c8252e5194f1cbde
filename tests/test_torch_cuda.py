"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card (a CUDA kernel has no CPU mode) and skip
without one.  This file imports neither JAX nor the tests' conftest, so
on a machine with a card it runs as

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from pytorch_geometric_signed_directed_tpu_torch.ops import spmm
from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import scatter_csr

# f32: the plain version on the card sums with atomics, in no fixed order
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
