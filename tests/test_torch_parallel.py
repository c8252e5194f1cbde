"""The kernel tier across a mesh: the port's 8-shard CPU mesh against the
JAX package on its 8-device CPU mesh (tests/conftest.py), for the
owner-computes partition, the sharded operator, the sharded fused pair and
the sharded trainable-q template (forward, dx and dq), and the sharded
models against the flat ones."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_signed_directed_tpu.ops import spmm as jx_spmm
from pytorch_geometric_signed_directed_tpu.ops.coalesce import (
    coalesce_edges)
from pytorch_geometric_signed_directed_tpu.ops.pallas import scatter_mxu
from pytorch_geometric_signed_directed_tpu.parallel import (
    make_mesh as jx_make_mesh,
    shard_dual as jx_shard_dual,
    shard_magnet_laplacian as jx_shard_magnet_laplacian,
    shard_propagator as jx_shard_propagator)
from pytorch_geometric_signed_directed_tpu.parallel.mxu_shard import (
    build_sharded_mxu as jx_build_sharded_mxu)
from pytorch_geometric_signed_directed_tpu.spectral import (
    magnetic_template as jx_magnetic_template,
    template_dual_apply as jx_template_dual_apply)

from pytorch_geometric_signed_directed_tpu_torch import parallel
from pytorch_geometric_signed_directed_tpu_torch.nn import (
    MagNet_node_classification)
from pytorch_geometric_signed_directed_tpu_torch.ops import (
    layout, make_propagator, spmm)
from pytorch_geometric_signed_directed_tpu_torch.ops.cuda.scatter_csr import (
    _row_ids)
from pytorch_geometric_signed_directed_tpu_torch.spectral import (
    magnet_propagators, magnetic_template, template_dual_apply)

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


@pytest.mark.parametrize("what", ["dense_pair", "segment_dual", "bsr",
                                  "dense_template", "segment_template"])
def test_other_tiers_are_not_sharded_yet(what, meshes):
    n = 60
    ei, w = template_graph(n, seed=3)
    mesh = meshes[0]
    with pytest.raises(NotImplementedError, match="item 17"):
        if what == "dense_pair":
            parallel.shard_magnet_laplacian(magnet_propagators(
                ei, w, num_nodes=n, mode="dense", device="cpu"), mesh)
        elif what == "segment_dual":
            parallel.shard_dual(magnet_propagators(
                ei, w, num_nodes=n, mode="segment", device="cpu").dual, mesh)
        elif what == "bsr":
            parallel.shard_propagator(make_propagator(
                ei[0], ei[1], w, n, mode="bsr", device="cpu"), mesh)
        else:
            parallel.shard_magnet_laplacian(magnetic_template(
                ei, w, num_nodes=n, mode=what.split("_")[0], device="cpu"),
                mesh)


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


def test_mesh_takes_the_first_cards_and_no_more(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert parallel.make_mesh().devices == (torch.device("cuda", 0),
                                            torch.device("cuda", 1))
    assert parallel.local_mesh().devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="have 2"):
        parallel.make_mesh(4)
