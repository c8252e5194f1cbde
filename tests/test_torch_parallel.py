"""The operators across a mesh: the port's 8-shard CPU mesh against the
JAX package on its 8-device CPU mesh (tests/conftest.py), for the kernel
tier's owner-computes partition, the sharded operator, the sharded fused
pair and the sharded trainable-q template (forward, dx and dq); the dense,
segment and bsr tiers, the segment pair and the dense and segment
templates sharded; the edge-partitioned SpMM; the sharded models against
the flat ones, and two trainings on a data x graph mesh against JAX's
vmapped step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_signed_directed_tpu.data import DSBM
from pytorch_geometric_signed_directed_tpu.nn import (
    MagNet_node_classification as JxMagNet)
from pytorch_geometric_signed_directed_tpu.ops import build_coo as jx_build_coo
from pytorch_geometric_signed_directed_tpu.ops import spmm as jx_spmm
from pytorch_geometric_signed_directed_tpu.ops.coalesce import (
    coalesce_edges)
from pytorch_geometric_signed_directed_tpu.ops.pallas import scatter_mxu
from pytorch_geometric_signed_directed_tpu.parallel import (
    partition_coo as jx_partition_coo,
    place as jx_place,
    sharded_spmm as jx_sharded_spmm,
    make_mesh as jx_make_mesh,
    shard_dual as jx_shard_dual,
    shard_magnet_laplacian as jx_shard_magnet_laplacian,
    shard_propagator as jx_shard_propagator)
from pytorch_geometric_signed_directed_tpu.parallel.mxu_shard import (
    build_sharded_mxu as jx_build_sharded_mxu)
from pytorch_geometric_signed_directed_tpu.spectral import (
    magnet_propagators as jx_magnet_propagators,
    magnetic_template as jx_magnetic_template,
    template_dual_apply as jx_template_dual_apply,
    template_propagators as jx_template_propagators)
from pytorch_geometric_signed_directed_tpu.utils import meta_graph_generation

from pytorch_geometric_signed_directed_tpu_torch import parallel
from pytorch_geometric_signed_directed_tpu_torch.convert import (
    state_dict_from_jax)
from pytorch_geometric_signed_directed_tpu_torch.nn import (
    MagNet_node_classification)
from pytorch_geometric_signed_directed_tpu_torch.ops import (
    build_coo, layout, make_propagator, spmm)
from pytorch_geometric_signed_directed_tpu_torch.ops.cuda.scatter_csr import (
    _row_ids)
from pytorch_geometric_signed_directed_tpu_torch.spectral import (
    magnet_propagators, magnetic_template, template_dual_apply,
    template_propagators)

from test_torch_worker_memory import release_memory  # noqa: F401

F32_TOL = dict(rtol=1e-5, atol=1e-5)
# dq across shards: per-shard partials summed in another order
# (tests/test_parallel.py holds the JAX package's sharded dq at 1e-3)
DQ_TOL = dict(rtol=1e-3, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# shard 0's coalesced edges reach about 0.5 coverage, the others about 0.15
SPLIT = dict(COL_SPLIT_MIN_COLS=100, GATHER_FAST_ROWS=32,
             COL_SPLIT_MIN_COVERAGE=0.4)


@pytest.fixture
def knobs(monkeypatch):
    def set_(**values):
        for k, v in values.items():
            monkeypatch.setattr(layout, k, v)
            monkeypatch.setattr(scatter_mxu, k, v)
    return set_


@pytest.fixture
def meshes():
    return parallel.make_mesh(8, device="cpu"), jx_make_mesh(8)


def mixed_edges(n, seed):
    """Device 0's rows send 90% of their edges to 4 hub columns (its shard
    splits); the other rows' columns are uniform (their shards fail the
    coverage gate), as tests/test_parallel.py builds them."""
    rng = np.random.default_rng(seed)
    rows_per = -(-n // 8)
    r0 = rng.integers(0, rows_per, 3000)
    c0 = np.where(rng.random(3000) < 0.9, rng.integers(0, 4, 3000),
                  rng.integers(0, n, 3000))
    r1 = rng.integers(rows_per, n, 6000)
    c1 = rng.integers(0, n, 6000)
    return coalesce_edges(
        np.concatenate([r0, r1]), np.concatenate([c0, c1]),
        rng.standard_normal(9000).astype(np.float32),
        rng.standard_normal(9000).astype(np.float32), num_cols=n)


def jax_shard_edges(J, d):
    """(row, col, val, val_b) of device d's edges in a JAX ShardedMXU."""
    win = np.asarray(J.win)[d]
    lr = np.asarray(J.local_rows)[d].reshape(-1)
    chunk = lr.size // win.size
    wins = np.repeat(win, chunk)
    valid = np.flatnonzero(lr < J.window)
    rows = d * J.rows_per_device + wins[valid] * J.window + lr[valid]
    col = np.asarray(J.col)[d][valid].astype(np.int64)
    if J.hot_ids is not None:
        hot = valid < J.hot_chunks * chunk
        col[hot] = np.asarray(J.hot_ids)[d][col[hot]]
    vb = None if J.val_b is None else np.asarray(J.val_b)[d][valid]
    return rows, col, np.asarray(J.val)[d][valid], vb


def port_shard_edges(S, d):
    sh = S.shards[d]
    L = sh.layout
    if not L.blocks:
        rows = _row_ids(L.rowptr).numpy()
    else:
        rows = torch.cat([_row_ids(b.rowptr) + b.row0
                          for b in L.blocks]).numpy()
    col = L.col.numpy().astype(np.int64)
    if L.hot_ids is not None:
        hot = np.arange(len(col)) < L.blocks[L.hot_blocks - 1].e1
        col[hot] = L.hot_ids.numpy()[col[hot]]
    vb = None if sh.val_b is None else sh.val_b.numpy()
    return d * S.rows_per_device + rows, col, sh.val.numpy(), vb


def edge_set(rows, col, val, vb):
    extra = [vb.tolist()] if vb is not None else []
    return sorted(zip(rows.tolist(), col.tolist(), val.tolist(), *extra))


# --- the partition ---------------------------------------------------------

@pytest.mark.parametrize("n", [512, 500])
def test_partition_matches_jax(n, meshes, knobs):
    knobs(**SPLIT)
    mesh, jmesh = meshes
    row, col, va, vb = mixed_edges(n, seed=11)
    S = parallel.build_sharded_mxu(row, col, va, n, n, mesh, val_b=vb)
    J = jx_build_sharded_mxu(row, col, va, n, n, jmesh, val_b=vb)
    assert S.rows_per_device == J.rows_per_device == -(-n // 8)
    split = [h is not None for h in S.hot_ids]
    assert split[0] and not any(split[1:])
    for d in range(8):
        assert edge_set(*port_shard_edges(S, d)) == \
            edge_set(*jax_shard_edges(J, d))
        if split[d]:
            np.testing.assert_array_equal(S.hot_ids[d].numpy(),
                                          np.asarray(J.hot_ids)[d])
    for d in range(8):                        # the transposed partition
        assert edge_set(*port_shard_edges(S.transposed, d)) == \
            edge_set(*jax_shard_edges(J.transposed, d))


def test_col_split_false_keeps_every_shard_flat(meshes, knobs):
    knobs(**SPLIT)
    row, col, va, _ = mixed_edges(512, seed=12)
    S = parallel.build_sharded_mxu(row, col, va, 512, 512, meshes[0],
                                   col_split=False)
    assert all(h is None and sh.layout.rowptr is not None
               for h, sh in zip(S.hot_ids, S.shards))


# --- sharded applies against the JAX package -------------------------------

def grad_both(port_fn, jax_fn, jmesh, x, g):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port_fn(xt)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    with jmesh:
        want, vjp = jax.vjp(jax.jit(lambda v: jax_fn(v)), jnp.asarray(x))
        (want_dx,) = vjp(jnp.asarray(g))
    return ((out.detach().numpy(), np.asarray(want)),
            (dx.numpy(), np.asarray(want_dx)))


@pytest.mark.parametrize("split", [False, True])
def test_sharded_propagator_matches_jax(split, meshes, knobs):
    if split:
        knobs(**SPLIT)
    mesh, jmesh = meshes
    n = 500
    row, col, val, _ = mixed_edges(n, seed=13)
    P = parallel.shard_propagator(
        make_propagator(row, col, val, n, mode="mxu", device="cpu"), mesh)
    J = jx_shard_propagator(jx_spmm.make_propagator(row, col, val, n,
                                                    mode="mxu"), jmesh)
    assert P.mode == J.mode == "mxu_sharded"
    assert (P.sharded.hot_ids[0] is not None) == split
    rng = np.random.default_rng(13)
    x, g = (rng.standard_normal((n, 8)).astype(np.float32) for _ in range(2))
    fwd, bwd = grad_both(P, J, jmesh, x, g)
    np.testing.assert_allclose(*fwd, **F32_TOL)
    np.testing.assert_allclose(*bwd, **F32_TOL)


def test_sharded_dual_matches_jax(meshes):
    mesh, jmesh = meshes
    n = 512
    row, col, va, vb = mixed_edges(n, seed=14)
    D = parallel.shard_dual(spmm.dual_propagator(row, col, va, vb, n,
                                                 mode="mxu", device="cpu"),
                            mesh)
    J = jx_shard_dual(jx_spmm.dual_propagator(row, col, va, vb, n,
                                              mode="mxu"), jmesh)
    assert D.mode == "mxu_sharded" and D.transposed.mode == "mxu_sharded"
    rng = np.random.default_rng(14)
    x, g = (rng.standard_normal((n, 16)).astype(np.float32)
            for _ in range(2))
    fwd, bwd = grad_both(lambda v: spmm.dual_spmm_stacked(D, v),
                         lambda v: jx_spmm.dual_spmm_stacked(J, v), jmesh,
                         x, g)
    np.testing.assert_allclose(*fwd, **F32_TOL)
    np.testing.assert_allclose(*bwd, **F32_TOL)


def template_graph(n, seed):
    rng = np.random.default_rng(seed)
    ei = np.vstack([rng.integers(0, n, 3000), rng.integers(0, n, 3000)])
    return ei, rng.random(3000).astype(np.float32)


@pytest.mark.parametrize("n", [384, 380])
def test_sharded_template_matches_jax_and_flat(n, meshes):
    """Forward, dx and dq of the sharded template (K1 per shard forward,
    K3 per shard backward) against the JAX package's sharded template and
    the port's flat one."""
    mesh, jmesh = meshes
    ei, w = template_graph(n, seed=13)
    flat = magnetic_template(ei, w, num_nodes=n, mode="mxu", device="cpu")
    T = parallel.shard_magnet_laplacian(flat, mesh)
    J = jx_shard_magnet_laplacian(
        jx_magnetic_template(ei, w, num_nodes=n, mode="mxu"), jmesh)
    assert T.mode == J.mode == "mxu_sharded"
    rng = np.random.default_rng(n)
    x, g = (rng.standard_normal((n, 16)).astype(np.float32)
            for _ in range(2))
    q0 = 0.21

    def jf(q, v):
        return jnp.sum(jx_template_dual_apply(J, q, v) * g)

    with jmesh:
        want = np.asarray(jax.jit(lambda q, v: jx_template_dual_apply(
            J, q, v))(q0, jnp.asarray(x)))
        jdq, jdx = jax.jit(jax.grad(jf, argnums=(0, 1)))(q0, jnp.asarray(x))
    got = {}
    for name, t in (("sharded", T), ("flat", flat)):
        q = torch.tensor(q0, requires_grad=True)
        xt = torch.from_numpy(x).requires_grad_(True)
        y = template_dual_apply(t, q, xt)
        (y * torch.from_numpy(g)).sum().backward()
        got[name] = (y.detach().numpy(), q.grad.item(), xt.grad.numpy())
    for y, dq, dx in got.values():
        np.testing.assert_allclose(y, want, **F32_TOL)
        np.testing.assert_allclose(dx, np.asarray(jdx), **F32_TOL)
        np.testing.assert_allclose(dq, float(jdq), **DQ_TOL)


# --- the models ------------------------------------------------------------

def model_grads(model, x, y, lap):
    logp = model(x, x, lap)
    loss = torch.nn.functional.nll_loss(logp, y)
    loss.backward()
    return loss.item(), {k: p.grad.clone()
                         for k, p in model.named_parameters()}


def test_sharded_trainable_q_grad_step_matches_flat(meshes):
    n = 256
    ei, _ = template_graph(n, seed=17)
    flat = magnetic_template(ei, None, num_nodes=n, mode="mxu", device="cpu")
    sharded = parallel.shard_magnet_laplacian(flat, meshes[0])
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, n))
    out = []
    for lap in (flat, sharded):
        model = MagNet_node_classification(
            num_features=4, hidden=8, K=2, label_dim=3, trainable_q=True,
            q=0.2, activation=True, device="cpu",
            generator=torch.Generator().manual_seed(0))
        loss, grads = model_grads(model, x, y, lap)
        torch.optim.Adam(model.parameters(), lr=1e-2).step()
        out.append((loss, grads, model.convs[0].q.item()))
    (l0, g0, q0), (l1, g1, q1) = out
    np.testing.assert_allclose(l1, l0, **GRAD_TOL)
    assert "convs.0.q" in g0
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], msg=k, **GRAD_TOL)
    np.testing.assert_allclose(q1, q0, rtol=1e-6)


def test_sharded_frozen_q_model_matches_flat(meshes):
    n = 200
    ei, w = template_graph(n, seed=19)
    lap = magnet_propagators(ei, w, q=0.25, num_nodes=n, mode="mxu",
                             device="cpu")
    lap_s = parallel.shard_magnet_laplacian(lap, meshes[0])
    assert lap_s.dual.mode == lap_s.re.mode == "mxu_sharded"
    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.random((n, 2)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, n))
    res = []
    for L in (lap, lap_s):
        model = MagNet_node_classification(
            num_features=2, hidden=8, K=2, label_dim=3, activation=True,
            device="cpu", generator=torch.Generator().manual_seed(1))
        res.append(model_grads(parallel.replicate(model, meshes[0]),
                               x, y, L))
    np.testing.assert_allclose(res[1][0], res[0][0], **GRAD_TOL)
    for k in res[0][1]:
        torch.testing.assert_close(res[1][1][k], res[0][1][k], msg=k,
                                   **GRAD_TOL)
    xs = torch.randn(n, 5)
    torch.testing.assert_close(lap_s.re(xs), lap.re(xs), **F32_TOL)
    torch.testing.assert_close(lap_s.im(xs), lap.im(xs), **F32_TOL)


# --- the dense, segment and bsr tiers ------------------------------------

def dsbm_graph():
    """tests/test_parallel.py's graph: DSBM(128, 3, 0.3) on a cyclic
    meta-graph."""
    F = meta_graph_generation("cyclic", 3, 0.05, False)
    A, labels = DSBM(128, 3, 0.3, F, rng=np.random.default_rng(0))
    return np.vstack(A.nonzero()), A.tocoo().data, labels


@pytest.mark.parametrize("mode", ["dense", "segment", "bsr"])
def test_sharded_tier_matches_jax(mode, meshes):
    """A sharded dense, segment or bsr operator keeps its mode; forward
    and backward against the JAX package's sharded operator at 1e-5 (its
    flat one on the bsr tier: JAX places the blocks 8 ways only when 8
    divides their count, and this graph has one block)."""
    mesh, jmesh = meshes
    ei, w, _ = dsbm_graph()
    n = 128
    P = parallel.shard_propagator(
        make_propagator(ei[0], ei[1], w, n, mode=mode, device="cpu"), mesh)
    J = jx_spmm.make_propagator(ei[0], ei[1], w, n, mode=mode)
    if mode != "bsr":
        J = jx_shard_propagator(J, jmesh)
    assert P.mode == J.mode == mode and P.sharded is not None
    assert P.num_nodes == n
    rng = np.random.default_rng(1)
    x, g = (rng.standard_normal((n, 16)).astype(np.float32)
            for _ in range(2))
    fwd, bwd = grad_both(P, J, jmesh, x, g)
    np.testing.assert_allclose(*fwd, **F32_TOL)
    np.testing.assert_allclose(*bwd, **F32_TOL)


def test_bsr_shards_own_whole_block_rows(meshes):
    """N=1000: 8 block rows, one a shard; 4 shards own 2 each and the
    transposed partition the same; K5's plan is each shard's own."""
    n = 1000
    rng = np.random.default_rng(2)
    ei = np.vstack([rng.integers(0, n, 3000), rng.integers(0, 500, 3000)])
    P = make_propagator(ei[0], ei[1], None, n, mode="bsr", device="cpu")
    S = parallel.shard_propagator(P, parallel.make_mesh(4, device="cpu"))
    B = S.sharded
    assert B.rows_per_device == 256 and B.transposed.rows_per_device == 256
    blocks = sum(b.blocks.shape[0] for b in B.shards)
    assert blocks == P.bsr.blocks.shape[0]
    for b in B.shards + B.transposed.shards:
        assert b.block_rowptr.numel() == 3 and b.num_rows == 256
        assert b.split.ptr.numel() == 3
    x = torch.randn(n, 5)
    torch.testing.assert_close(S(x), P(x), **F32_TOL)


def template_of(what, n, ei, w):
    mode = what.split("_")[0]
    return (magnetic_template(ei, w, num_nodes=n, mode=mode, device="cpu"),
            jx_magnetic_template(ei, w, num_nodes=n, mode=mode))


@pytest.mark.parametrize("what", ["dense_pair", "segment_dual", "bsr",
                                  "dense_template", "segment_template"])
def test_other_tiers_shard_and_match_jax(what, meshes):
    """The five tiers beside the kernel tier: the dense pair, the
    segment dual, the bsr tier and the dense and segment templates,
    sharded 8 ways (n=64: the JAX package shards a dense operator only
    when 8 divides its rows) against the
    JAX package's sharded ones, forward and backward (dq included) at
    1e-5 (dq at the sharded tolerance)."""
    mesh, jmesh = meshes
    n = 64
    ei, w = template_graph(n, seed=3)
    rng = np.random.default_rng(4)
    x, g = (rng.standard_normal((n, 8)).astype(np.float32)
            for _ in range(2))
    if what == "dense_pair":
        lap = parallel.shard_magnet_laplacian(magnet_propagators(
            ei, w, num_nodes=n, mode="dense", device="cpu"), mesh)
        jlap = jx_shard_magnet_laplacian(jx_magnet_propagators(
            ei, w, num_nodes=n, mode="dense"), jmesh)
        assert lap.dual is None and lap.re.mode == "dense"
        for P, J in ((lap.re, jlap.re), (lap.im, jlap.im)):
            fwd, bwd = grad_both(P, J, jmesh, x, g)
            np.testing.assert_allclose(*fwd, **F32_TOL)
            np.testing.assert_allclose(*bwd, **F32_TOL)
    elif what == "segment_dual":
        D = parallel.shard_dual(magnet_propagators(
            ei, w, num_nodes=n, mode="segment", device="cpu").dual, mesh)
        J = jx_shard_dual(jx_magnet_propagators(
            ei, w, num_nodes=n, mode="segment").dual, jmesh)
        assert D.mode == J.mode == "segment"
        assert D.sharded.transposed is not None
        fwd, bwd = grad_both(lambda v: spmm.dual_spmm_stacked(D, v),
                             lambda v: jx_spmm.dual_spmm_stacked(J, v),
                             jmesh, x, g)
        np.testing.assert_allclose(*fwd, **F32_TOL)
        np.testing.assert_allclose(*bwd, **F32_TOL)
    elif what == "bsr":
        # 8 x 8 blocks, all touched: JAX places 64 blocks 8 ways
        nb = 1024
        eb = np.vstack([rng.integers(0, nb, 3000), rng.integers(0, nb, 3000)])
        P = parallel.shard_propagator(make_propagator(
            eb[0], eb[1], None, nb, mode="bsr", device="cpu"), mesh)
        J = jx_shard_propagator(jx_spmm.make_propagator(
            eb[0], eb[1], None, nb, mode="bsr"), jmesh)
        assert P.mode == J.mode == "bsr" and J.bsr.blocks.shape[0] == 64
        xb, gb = (rng.standard_normal((nb, 8)).astype(np.float32)
                  for _ in range(2))
        fwd, bwd = grad_both(P, J, jmesh, xb, gb)
        np.testing.assert_allclose(*fwd, **F32_TOL)
        np.testing.assert_allclose(*bwd, **F32_TOL)
    else:
        tmpl, jtmpl = template_of(what, n, ei, w)
        T = parallel.shard_magnet_laplacian(tmpl, mesh)
        JT = jx_shard_magnet_laplacian(jtmpl, jmesh)
        assert T.mode == JT.mode == what.split("_")[0]
        q0 = 0.21

        def jf(q, v):
            a, b = jx_template_propagators(JT, q)
            return jnp.sum(a(v) * g) + jnp.sum(b(v) ** 2)

        with jmesh:
            jv, (jdq, jdx) = jax.jit(jax.value_and_grad(
                jf, argnums=(0, 1)))(q0, jnp.asarray(x))
        q = torch.tensor(q0, requires_grad=True)
        xt = torch.from_numpy(x).requires_grad_(True)
        a, b = template_propagators(T, q)
        assert a.sharded is not None and a.mode == T.mode
        v = (a(xt) * torch.from_numpy(g)).sum() + (b(xt) ** 2).sum()
        v.backward()
        np.testing.assert_allclose(v.item(), float(jv), **F32_TOL)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx),
                                   **F32_TOL)
        np.testing.assert_allclose(q.grad.item(), float(jdq), **DQ_TOL)


# --- the edge-partitioned SpMM -------------------------------------------

@pytest.mark.parametrize("n", [128, 101])
def test_partition_coo_bit_equal_and_sharded_spmm(n, meshes):
    mesh, jmesh = meshes
    rng = np.random.default_rng(7)
    if n == 128:
        ei, w, _ = dsbm_graph()
        row, col, val = ei[0], ei[1], w.astype(np.float32)
    else:
        row, col = rng.integers(0, n, 700), rng.integers(0, n, 700)
        val = rng.standard_normal(700).astype(np.float32)
    A = build_coo(row, col, val, n, sum_duplicates=True, device="cpu")
    JA = jx_build_coo(row, col, val, n, sum_duplicates=True)
    pc = parallel.partition_coo(A, 8)
    jpc = jx_partition_coo(JA, 8)
    assert (pc.rows_per_device, pc.n_devices, pc.num_nodes) == \
        (jpc.rows_per_device, jpc.n_devices, jpc.num_nodes)
    for a, b in ((pc.row, jpc.row), (pc.col, jpc.col), (pc.val, jpc.val)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.shape[1] % 8 == 0
        np.testing.assert_array_equal(a, b)
    x, g = (rng.standard_normal((n, 5)).astype(np.float32) for _ in range(2))
    placed = parallel.place(pc, mesh)
    jplaced = jx_place(jpc, jmesh)
    fwd, bwd = grad_both(lambda v: parallel.sharded_spmm(placed, v, mesh),
                         lambda v: jx_sharded_spmm(jplaced, v, jmesh),
                         jmesh, x, g)
    np.testing.assert_allclose(*fwd, **F32_TOL)
    np.testing.assert_allclose(*bwd, **F32_TOL)
    with pytest.raises(ValueError, match="place"):
        parallel.sharded_spmm(pc, torch.from_numpy(x), mesh)


# --- the data x graph mesh -------------------------------------------------

@pytest.mark.parametrize("mode", ["segment", "dense"])
def test_two_axis_mesh_trains_like_jax(mode):
    """A (2, 4) ("data", "graph") mesh: two trainings from two seeds, each
    on its data row's 4-shard graph mesh, against JAX's vmapped
    single-device step (tests/test_parallel.py), two Adam steps each."""
    import optax

    rng = np.random.default_rng(0)
    n, e = 64, 400
    ei = np.vstack([rng.integers(0, n, e), rng.integers(0, n, e)])
    w = rng.random(e).astype(np.float32)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = rng.integers(0, 3, n)
    jlap = jx_magnet_propagators(ei, w, q=0.25, num_nodes=n, mode=mode)
    jm = JxMagNet(num_features=4, hidden=8, K=2, label_dim=3,
                  activation=True)
    tx = optax.adam(1e-2)

    def one_step(params, opt_state):
        def loss_fn(p):
            logp = jm.apply(p, x, x, jlap)
            return -jnp.mean(logp[jnp.arange(n), y])

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    stack = jax.vmap(lambda k: jm.init(k, x, x, jlap))(keys)
    step = jax.jit(jax.vmap(one_step))
    p1, s1, l1 = step(stack, jax.vmap(tx.init)(stack))
    _, _, l2 = step(p1, s1)
    want = np.stack([np.asarray(l1), np.asarray(l2)], 1)

    mesh = parallel.make_mesh(shape=(2, 4), axis_names=("data", "graph"),
                              device="cpu")
    assert mesh.shape == (2, 4) and mesh.axis_size("graph") == 4
    with pytest.raises(ValueError, match="submesh"):
        parallel.shard_magnet_laplacian(magnet_propagators(
            ei, w, q=0.25, num_nodes=n, mode=mode, device="cpu"), mesh)
    lap = magnet_propagators(ei, w, q=0.25, num_nodes=n, mode=mode,
                             device="cpu")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for i in range(2):
        sub = mesh.submesh(data=i)
        assert sub.axis_names == ("graph",) and sub.size == 4
        lap_s = parallel.shard_magnet_laplacian(lap, sub)
        model = MagNet_node_classification(
            num_features=4, hidden=8, K=2, label_dim=3, activation=True,
            device="cpu")
        model.load_state_dict(state_dict_from_jax(jax.device_get(
            jax.tree_util.tree_map(lambda a: a[i], stack))))
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        losses = []
        for _ in range(2):
            opt.zero_grad()
            loss = torch.nn.functional.nll_loss(model(xt, xt, lap_s), yt)
            loss.backward()
            opt.step()
            losses.append(loss.item())
        np.testing.assert_allclose(losses, want[i], rtol=1e-4, atol=1e-5)


# --- the mesh --------------------------------------------------------------

def test_mesh_on_the_cpu_and_its_collectives():
    mesh = parallel.make_mesh(8, device="cpu")
    assert mesh.size == 8 and all(d.type == "cpu" for d in mesh.devices)
    assert parallel.local_mesh(device="cpu").size == 1
    blocks = [torch.full((2, 3), float(i)) for i in range(8)]
    torch.testing.assert_close(parallel.all_gather(blocks, mesh),
                               torch.cat(blocks))
    assert parallel.psum([torch.tensor(float(i)) for i in range(8)],
                         mesh).item() == 28.0


def test_mesh_shape_axes_and_submeshes():
    mesh = parallel.make_mesh(shape=(2, 4), axis_names=("data", "graph"),
                              device="cpu")
    assert mesh.size == 8 and mesh.local == tuple(range(8))
    assert parallel.make_mesh(8, axis_names=("graph", "data"),
                              device="cpu").shape == (8, 1)
    devs = tuple(torch.device("cpu", i) for i in range(6))
    m = parallel.Mesh(devs, shape=(2, 3), axis_names=("data", "graph"))
    assert m.submesh(data=1).devices == devs[3:]
    assert m.submesh(graph=2).devices == (devs[2], devs[5])
    assert m.submesh(graph=2).axis_names == ("data",)
    with pytest.raises(ValueError, match="every axis but one"):
        m.submesh()
    with pytest.raises(ValueError, match="does not hold"):
        parallel.Mesh(devs, shape=(4, 2), axis_names=("data", "graph"))
    with pytest.raises(ValueError, match="differ in length"):
        parallel.make_mesh(shape=(2, 4), device="cpu")


def test_mesh_takes_the_first_cards_and_no_more(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert parallel.make_mesh().devices == (torch.device("cuda", 0),
                                            torch.device("cuda", 1))
    assert parallel.local_mesh().devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="have 2"):
        parallel.make_mesh(4)
    with pytest.raises(ValueError, match="have 2"):
        parallel.make_mesh(shape=(2, 2), axis_names=("data", "graph"))
    assert parallel.make_mesh(shape=(1, 2), axis_names=(
        "data", "graph")).submesh(data=0).devices == (
            torch.device("cuda", 0), torch.device("cuda", 1))
