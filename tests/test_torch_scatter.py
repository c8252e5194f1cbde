"""The port's K1 counterpart (CSR dual apply and scatter sum) vs the JAX
package's Pallas K1 path (interpret mode on the CPU).

On the CPU the port's wrappers run their plain PyTorch versions; the
kernels themselves are held against those versions on the card by
tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_signed_directed_tpu.ops import spmm as jx_spmm
from pytorch_geometric_signed_directed_tpu.ops.pallas.scatter_mxu import (
    build_scatter_plan, permute_edge_data, scatter_sum as jx_scatter_sum)

from pytorch_geometric_signed_directed_tpu_torch.ops import spmm
from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import scatter_csr

# f32: the port sums each row in edge order, the TPU kernel in one-hot
# matmul order — the sums agree to rounding, not bit for bit
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 messages: both round every message to bf16 (8 bits of mantissa)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def operator(n_rows, n_cols, e, seed):
    """Random edge list with duplicate edges and empty rows."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n_rows // 2, e) * 2     # odd rows stay empty
    col = rng.integers(0, n_cols, e)
    row[: e // 10], col[: e // 10] = row[-(e // 10):], col[-(e // 10):]
    va = rng.standard_normal(e).astype(np.float32)
    vb = rng.standard_normal(e).astype(np.float32)
    return row, col, va, vb


CASES = {
    # (n_rows, n_cols, edges): width 2F from the MagNet path (4, 64) and
    # the f=19 probe (38); one rectangular operator
    "w4": (300, 300, 2500, 4),
    "w38": (300, 300, 2500, 38),
    "w64": (300, 300, 2500, 64),
    "rect_w8": (160, 240, 1200, 8),
}


def build_both(case, seed=0):
    n_rows, n_cols, e, w = CASES[case]
    row, col, va, vb = operator(n_rows, n_cols, e, seed)
    D = spmm.dual_propagator(row, col, va, vb, n_rows, n_cols, mode="mxu",
                             device="cpu")
    J = jx_spmm.dual_propagator(row, col, va, vb, n_rows, n_cols,
                                mode="mxu")
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((n_cols, w)).astype(np.float32)
    g = rng.standard_normal((n_rows, w)).astype(np.float32)
    return D, J, x, g


@pytest.mark.parametrize("case", list(CASES))
def test_dual_spmm_stacked_forward_backward(case):
    D, J, x, g = build_both(case)
    assert D.mode == "mxu" and J.mode == "mxu"

    xt = torch.from_numpy(x).requires_grad_(True)
    out = spmm.dual_spmm_stacked(D, xt)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))

    want, vjp = jax.vjp(lambda v: jx_spmm.dual_spmm_stacked(J, v),
                        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **F32_TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **F32_TOL)
    # rows without edges are exactly zero (K1's visited mask)
    assert np.all(out.detach().numpy()[1::2] == 0)


def test_dual_spmm_stacked_segment_tier_matches_mxu():
    n_rows, n_cols, e, w = CASES["rect_w8"]
    row, col, va, vb = operator(n_rows, n_cols, e, 5)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (n_cols, w)).astype(np.float32))
    outs = [spmm.dual_spmm_stacked(
        spmm.dual_propagator(row, col, va, vb, n_rows, n_cols, mode=m,
                             device="cpu"), x) for m in ("segment", "mxu")]
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), **F32_TOL)


@pytest.mark.parametrize("case", ["w4", "w64"])
def test_bf16_messages_match_jax(case):
    D, J, x, g = build_both(case, seed=3)
    jx_spmm.set_message_dtype("bf16")
    spmm.set_message_dtype("bf16")
    try:
        xt = torch.from_numpy(x).requires_grad_(True)
        out = spmm.dual_spmm_stacked(D, xt)
        (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
        want, vjp = jax.vjp(lambda v: jx_spmm.dual_spmm_stacked(J, v),
                            jnp.asarray(x))
        (want_dx,) = vjp(jnp.asarray(g))
    finally:
        jx_spmm.set_message_dtype(None)
        spmm.set_message_dtype(None)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **BF16_TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **BF16_TOL)
    # and the rounding really happened: not the f32 result
    f32 = spmm.dual_spmm_stacked(D, torch.from_numpy(x)).numpy()
    assert np.abs(out.detach().numpy() - f32).max() > 0


def test_bf16_rounds_the_product():
    """The message is round_bf16(val * x), not val * round_bf16(x)."""
    rowptr = torch.tensor([0, 1], dtype=torch.int32)
    col = torch.zeros(1, dtype=torch.int32)
    val = torch.tensor([1.0 + 2.0 ** -9], dtype=torch.float32)
    x = torch.ones((1, 2), dtype=torch.bfloat16)
    out = scatter_csr.csr_dual_spmm(rowptr, col, val, val, x, 1)
    assert torch.all(out == 1.0)          # the product rounded to bf16
    out32 = scatter_csr.csr_dual_spmm(rowptr, col, val, val, x.float(), 1)
    assert torch.all(out32 == val)


@pytest.mark.parametrize("width", [4, 38, 64])
def test_csr_scatter_sum_matches_jax(width):
    n, e = 300, 2500
    row, _, _, _ = operator(n, n, e, seed=width)
    msgs = np.random.default_rng(width).standard_normal(
        (e, width)).astype(np.float32)
    order = np.argsort(row, kind="stable")
    rowptr = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(np.bincount(row, minlength=n))]).astype(np.int32))
    out = scatter_csr.csr_scatter_sum(rowptr, torch.from_numpy(msgs[order]))

    plan, perm = build_scatter_plan(row, n)
    (msgs_plan,) = permute_edge_data(perm, msgs)
    want = jx_scatter_sum(plan, jnp.asarray(msgs_plan))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **F32_TOL)
    assert np.all(out.numpy()[1::2] == 0)

    bf = torch.from_numpy(msgs[order]).to(torch.bfloat16)
    np.testing.assert_allclose(
        scatter_csr.csr_scatter_sum(rowptr, bf).numpy(),
        np.asarray(jx_scatter_sum(plan, jnp.asarray(msgs_plan,
                                                    jnp.bfloat16))),
        **BF16_TOL)


def test_single_operator_mxu_propagator_matches_jax():
    n_rows, _, e, w = CASES["rect_w8"]
    row, col, va, _ = operator(n_rows, n_rows, e, seed=9)
    P = spmm.make_propagator(row, col, va, n_rows, mode="mxu", device="cpu")
    J = jx_spmm.make_propagator(row, col, va, n_rows, mode="mxu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((n_rows, w)).astype(np.float32)
    g = rng.standard_normal((n_rows, w)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = P(xt)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    want, vjp = jax.vjp(J, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **F32_TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **F32_TOL)


def test_width_errors():
    row, col, va, vb = operator(100, 100, 400, seed=5)
    D = spmm.dual_propagator(row, col, va, vb, 100, mode="segment",
                             device="cpu")
    with pytest.raises(ValueError, match="feature width"):
        spmm.dual_spmm(D, torch.ones(100, 8), torch.ones(100, 6))
    for mode in ("segment", "mxu"):
        D = spmm.dual_propagator(row, col, va, vb, 100, mode=mode,
                                 device="cpu")
        with pytest.raises(ValueError, match="even"):
            spmm.dual_spmm_stacked(D, torch.ones(100, 7))


@pytest.mark.parametrize("mode", ["segment", "mxu"])
def test_builders_reject_out_of_range_edges(mode):
    with pytest.raises(ValueError, match="outside"):
        spmm.dual_propagator([0, 5], [1, 2], [1.0, 1.0], [1.0, 1.0],
                             num_nodes=4, mode=mode, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        spmm.dual_propagator([0, 1], [1, -1], [1.0, 1.0], [1.0, 1.0],
                             num_nodes=4, mode=mode, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        spmm.make_propagator([0, 1], [1, 9], None, 4, mode=mode,
                             device="cpu")


def test_mode_strings():
    row, col, va, vb = operator(100, 100, 400, seed=6)
    assert spmm.dual_propagator(row, col, va, vb, 100, device="cpu") is None
    assert spmm.dual_propagator(row, col, va, vb, 9000,
                                device="cpu").mode == "mxu"
    with pytest.raises(NotImplementedError, match="K5"):
        spmm.make_propagator(row, col, va, 100, mode="bsr", device="cpu")
