"""The port's ``bsr`` tier (host blocks, the K5 counterpart and its
transposed backward, graph reordering) against the JAX package's (the
Pallas K5 in interpret mode on the CPU).

On the CPU the port's ``bsr_matmul`` runs its plain version; the kernel
itself is held against that version on the card by tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_signed_directed_tpu.nn import (
    MagNet_node_classification as JxMagNetNode)
from pytorch_geometric_signed_directed_tpu.ops import build_coo as jx_build_coo
from pytorch_geometric_signed_directed_tpu.ops import reorder as jx_reorder
from pytorch_geometric_signed_directed_tpu.ops import spmm as jx_spmm
from pytorch_geometric_signed_directed_tpu.ops.pallas.bsr_spmm import (
    bsr_from_coo as jx_bsr_from_coo, bsr_spmm as jx_bsr_spmm)
from pytorch_geometric_signed_directed_tpu.spectral import (
    magnet_propagators as jx_magnet_propagators)

from pytorch_geometric_signed_directed_tpu_torch.convert import (
    state_dict_from_jax)
from pytorch_geometric_signed_directed_tpu_torch.nn import (
    MagNet_node_classification)
from pytorch_geometric_signed_directed_tpu_torch.ops import (
    bsr as bsr_mod, build_coo, reorder, spmm)
from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import bsr_spmm
from pytorch_geometric_signed_directed_tpu_torch.spectral import (
    magnet_propagators)

from test_torch_worker_memory import release_memory  # noqa: F401

# float32 at HIGHEST on both sides, summed in other orders
F32_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)

CASES = {
    # (n_rows, n_cols, edges, width): the cases of tests/test_bsr_spmm.py
    "square": (300, 300, 2000, 16),
    "rect": (130, 520, 900, 40),
}


def make_case(n_rows, n_cols, e, f, seed):
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n_rows, e)
    col = rng.integers(0, n_cols, e)
    val = rng.standard_normal(e).astype(np.float32)
    x = rng.standard_normal((n_cols, f)).astype(np.float32)
    g = rng.standard_normal((n_rows, f)).astype(np.float32)
    return row, col, val, x, g


def both_bsr(row, col, val, n_rows, n_cols):
    B = bsr_mod.bsr_from_coo(build_coo(row, col, val, n_rows,
                                       num_cols=n_cols, device="cpu"))
    J = jx_bsr_from_coo(jx_build_coo(row, col, val, n_rows,
                                     num_cols=n_cols))
    return B, J


@pytest.mark.parametrize("case", ["square", "rect", "empty_block_rows"])
def test_bsr_arrays_are_bit_equal(case):
    if case == "empty_block_rows":
        row, col, val = np.array([0, 300]), np.array([5, 7]), \
            np.array([1.0, 2.0], np.float32)
        n_rows = n_cols = 400
    else:
        n_rows, n_cols, e, f = CASES[case]
        row, col, val, _, _ = make_case(n_rows, n_cols, e, f, seed=n_rows)
    B, J = both_bsr(row, col, val, n_rows, n_cols)
    for b, j in ((B, J), (B.transposed, J.transposed)):
        assert (b.num_rows, b.num_cols) == (j.num_rows, j.num_cols)
        for name in ("blocks", "block_rows", "block_cols"):
            got, want = getattr(b, name).numpy(), np.asarray(getattr(j, name))
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        # the kernel's block-row pointer names the same blocks
        brp = b.block_rowptr.numpy()
        np.testing.assert_array_equal(
            np.repeat(np.arange(len(brp) - 1), np.diff(brp)),
            b.block_rows.numpy())


@pytest.mark.parametrize("case", list(CASES))
def test_bsr_spmm_and_its_gradient_match_jax(case):
    n_rows, n_cols, e, f = CASES[case]
    row, col, val, x, g = make_case(n_rows, n_cols, e, f, seed=n_rows)
    B, J = both_bsr(row, col, val, n_rows, n_cols)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = bsr_mod.bsr_spmm(B, xt)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    want, vjp = jax.vjp(lambda v: jx_bsr_spmm(J, v),
                        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **F32_TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **F32_TOL)
    dense = np.zeros((n_rows, n_cols))
    np.add.at(dense, (row, col), val)
    np.testing.assert_allclose(out.detach().numpy(), dense @ x, **F32_TOL)


def test_bsr_empty_block_rows_are_zero():
    row, col, val = np.array([0, 300]), np.array([5, 7]), \
        np.array([1.0, 2.0], np.float32)
    B, J = both_bsr(row, col, val, 400, 400)
    x = np.ones((400, 8), np.float32)
    out = bsr_mod.bsr_spmm(B, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        out, np.asarray(jx_bsr_spmm(J, jnp.asarray(x))))
    assert out[0, 0] == 1.0 and out[300, 0] == 2.0
    assert np.abs(out[128:256]).sum() == 0


@pytest.mark.parametrize("width", [2, 32])
def test_bsr_matmul_plain_is_the_block_product(width):
    """K5's plain version (bmm of the blocks with their x tiles, then a
    sum by block row) at the MagNet path's widths."""
    row, col, val, x, _ = make_case(300, 260, 2500, width, seed=width)
    B, _ = both_bsr(row, col, val, 300, 260)
    out = bsr_spmm.bsr_matmul_plain(B.blocks, B.block_rowptr, B.block_cols,
                                    torch.from_numpy(x), 300)
    dense = np.zeros((300, 260))
    np.add.at(dense, (row, col), val)
    assert out.shape == (300, width) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), dense @ x, **F32_TOL)


def test_bsr_propagator_tier_matches_jax():
    row, col, val, x, _ = make_case(256, 256, 2000, 12, seed=11)
    P = spmm.make_propagator(row, col, val, 256, mode="bsr", device="cpu")
    J = jx_spmm.make_propagator(row, col, val, 256, mode="bsr")
    assert P.mode == "bsr" and P.num_nodes == 256
    np.testing.assert_allclose(P(torch.from_numpy(x)).numpy(),
                               np.asarray(J(jnp.asarray(x))), **F32_TOL)


def test_bsr_rejects_too_many_blocks(monkeypatch):
    monkeypatch.setattr(bsr_mod, "_MAX_BLOCKS", 3)
    row, col, val, _, _ = make_case(300, 300, 2000, 4, seed=1)
    with pytest.raises(ValueError, match="blocks"):
        spmm.make_propagator(row, col, val, 300, mode="bsr", device="cpu")


def test_reorder_is_bit_equal():
    rng = np.random.default_rng(0)
    n, e = 500, 3000
    row, col = rng.integers(0, n, e), rng.integers(0, n, e)
    perm = reorder.rcm_permutation(row, col, n)
    np.testing.assert_array_equal(perm,
                                  jx_reorder.rcm_permutation(row, col, n))
    for a, b in zip(reorder.apply_permutation(row, col, perm),
                    jx_reorder.apply_permutation(row, col, perm)):
        np.testing.assert_array_equal(a, b)
    new_row, new_col, _ = reorder.apply_permutation(row, col, perm)
    assert reorder.block_density(new_row, new_col, n) == \
        jx_reorder.block_density(new_row, new_col, n)
    assert reorder.block_density(row, col, n) == \
        jx_reorder.block_density(row, col, n)


def test_magnet_on_the_bsr_tier_matches_jax():
    """Two single-operator Chebyshev stacks on K5 (no fused dual on this
    tier), at N=300: three block rows, the last one padded."""
    n = 300
    rng = np.random.default_rng(4)
    row, col = rng.integers(0, n, 2000), rng.integers(0, n, 2000)
    keep = row != col
    ei = np.stack([row[keep], col[keep]])
    w = rng.uniform(0.5, 1.5, ei.shape[1])
    lap = magnet_propagators(ei, w, q=0.25, num_nodes=n, mode="bsr",
                             device="cpu")
    jlap = jx_magnet_propagators(ei, w, q=0.25, num_nodes=n, mode="bsr")
    assert lap.dual is None and jlap.dual is None
    assert lap.re.mode == lap.im.mode == "bsr"
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
