"""The port's public signatures against the JAX package's, and the values
of the calls whose signatures were repaired to JAX's.

Every public function, class and method that a JAX module (its Pallas
kernels aside) defines has a counterpart of the same name in the port's
module, whose parameters begin with JAX's, in JAX's order.  The port may
add trailing parameters (``device``, ``generator``, ``aggregate``,
``fused``, ...).  A few differences follow from the frameworks and are
deliberate; each is listed below with its reason.
"""
import importlib
import inspect
import pathlib

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_geometric_signed_directed_tpu.ops import (
    build_coo as jx_build_coo, spmm as jx_spmm)
from pytorch_geometric_signed_directed_tpu.train import Trainer as JxTrainer

from pytorch_geometric_signed_directed_tpu_torch.ops import build_coo, spmm
from pytorch_geometric_signed_directed_tpu_torch.train import Trainer, adam

from test_torch_worker_memory import release_memory  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = "pytorch_geometric_signed_directed_tpu"
PORT_PKG = JAX_PKG + "_torch"
JAX = ROOT / JAX_PKG

# flax's own Module fields, which every flax layer's signature ends with
FLAX_FIELDS = ("parent", "name")
# JAX methods that belong to flax, not to the library: a Module's
# ``setup`` (the port builds its layers in ``__init__``) and a
# struct.dataclass's ``replace`` (the port's frozen dataclasses take
# ``dataclasses.replace``)
FLAX_METHODS = ("setup", "replace")

# (module, qualified name): why the signatures differ
DELIBERATE = {
    ("nn/directed/digcl.py", "DiGCL.warmup"):
        "flax initialises a model by running it (init(..., method=warmup) "
        "touches every submodule); torch modules build their parameters "
        "in __init__",
    ("nn/inits.py", "glorot"):
        "flax initializers take (key, shape, dtype); the port's take the "
        "shape and a torch.Generator and make float32 weights, which the "
        "layers move with .to()",
    ("nn/inits.py", "zeros"):
        "flax's initializer form (key, shape, dtype): see glorot",
    ("ops/coo.py", "COO"):
        "JAX's nnz field counts the valid entries of padded arrays; the "
        "port's COO holds exactly its entries and nnz is a property",
    ("ops/spmm.py", "Propagator"):
        "the TPU plan field mxu (an MXU window plan) is the port's csr "
        "(a CSR layout and its row plan), beside the port's sharded",
    ("ops/spmm.py", "DualPropagator"):
        "the TPU plan fields (plan, stream) are the port's CSR layout "
        "(rowptr, blocks, hot_blocks, streamed, row_split) and sharded",
    ("spectral/magnetic.py", "MagneticTemplate"):
        "the TPU plan fields (plan, stream) are the port's CSR layout "
        "(rowptr, blocks, hot_blocks, streamed, row_split) and sharded",
    ("parallel/mxu_shard.py", "ShardedMXU"):
        "the TPU's per-device window plans (win, local_rows, visited, "
        "col, val, ...) are the port's per-shard CSRs (shards)",
    ("parallel/attn_shard.py", "ShardedAttnGraph"):
        "the TPU's per-device window plans are the port's per-shard "
        "attention graphs (shards)",
}


def _params(obj):
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    return [p.name for p in sig.parameters.values()
            if p.name not in ("self", "cls")]


def _normalise(jobj, port_params):
    """JAX's parameters as the port spells them: a flax Module's own fields
    dropped, a PRNG key (``key``, or ``rng`` where the port has no
    ``rng``) taken by the port's trailing ``generator``, ``params`` as ``model`` (a torch
    module holds its parameters); and the port's parameters without the
    input width that a torch layer takes first (flax infers it)."""
    j = _params(jobj)
    if inspect.isclass(jobj) and issubclass(jobj, flax.linen.Module):
        j = [p for p in j if p not in FLAX_FIELDS]
    if "generator" in port_params:
        j = [p for p in j if not (p == "key" or
                                  (p == "rng" and "rng" not in port_params))]
    if "model" in port_params and "params" not in port_params:
        j = ["model" if p == "params" else p for p in j]
    port = list(port_params)
    if port[:1] and port[0] in ("in_dim", "in_channels") and \
            (not j or j[0] != port[0]):
        port = port[1:]
    return j, port


def _module_name(pkg, rel):
    parts = list(pathlib.Path(rel).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join([pkg] + parts)


def _public_items(rel):
    """(qualified name, JAX object, port object or None) for every public
    function and class the JAX module defines, and their methods."""
    jm = importlib.import_module(_module_name(JAX_PKG, rel))
    pm = importlib.import_module(_module_name(PORT_PKG, rel))
    out = []
    for name, obj in vars(jm).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != \
                jm.__name__:
            continue
        if not (inspect.isfunction(obj) or inspect.isclass(obj)):
            continue
        pobj = getattr(pm, name, None)
        out.append((name, obj, pobj))
        if not inspect.isclass(obj) or pobj is None:
            continue
        for m, f in vars(obj).items():
            if m.startswith("_") or isinstance(f, property) or not (
                    inspect.isfunction(f) or
                    isinstance(f, (staticmethod, classmethod))):
                continue
            out.append((f"{name}.{m}", getattr(obj, m),
                        getattr(pobj, m, None)))
    return out


MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py")
                 if p.relative_to(JAX).parts[:2] != ("ops", "pallas")
                 and p.name != "__init__.py")


@pytest.mark.parametrize("module", MODULES)
def test_port_signatures_begin_with_jaxs(module):
    faults = []
    for name, jobj, pobj in _public_items(module):
        if (module, name) in DELIBERATE or \
                name.rsplit(".", 1)[-1] in FLAX_METHODS and "." in name:
            continue
        if pobj is None:
            faults.append(f"{name}: no counterpart")
            continue
        jp, pp = _params(jobj), _params(pobj)
        if jp is None or pp is None:
            continue
        want, have = _normalise(jobj, pp)
        if have[:len(want)] != want:
            faults.append(f"{name}: JAX {jp}, port {pp}")
    assert faults == []


@pytest.mark.parametrize("module,name", sorted(DELIBERATE))
def test_each_deliberate_difference_is_still_one(module, name):
    """The list names real objects whose signatures still differ, so that
    it does not outlive what it excuses."""
    items = {n: (j, p) for n, j, p in _public_items(module)}
    jobj, pobj = items[name]
    if pobj is None:
        return                      # a flax-only method: no counterpart
    want, have = _normalise(jobj, _params(pobj))
    assert have[:len(want)] != want


# --- the repaired calls, against JAX ----------------------------------------

def coo_inputs(seed=0, n=40, m=30, e=300):
    rng = np.random.default_rng(seed)
    row, col = rng.integers(0, n, e), rng.integers(0, m, e)
    row[:30], col[:30] = row[-30:], col[-30:]          # duplicates
    return row, col, rng.standard_normal(e).astype(np.float32), n, m


def test_coo_transpose_and_to_scipy_match_jax():
    row, col, val, n, m = coo_inputs()
    A = build_coo(row, col, val, n, num_cols=m, device="cpu")
    J = jx_build_coo(row, col, val, n, num_cols=m)
    At, Jt = A.transpose(), J.transpose()
    assert At.shape == Jt.shape == (m, n) and At.nnz == Jt.nnz
    for a, j in ((At.row, Jt.row), (At.col, Jt.col), (At.val, Jt.val)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(j)[:Jt.nnz])
    for a, j in ((A, J), (At, Jt)):
        sa, sj = a.to_scipy(), j.to_scipy()
        assert sa.shape == sj.shape and sa.format == sj.format == "csr"
        np.testing.assert_array_equal(sa.toarray(), sj.toarray())


def test_build_coo_takes_the_padding_and_value_type_parameters():
    row, col, val, n, m = coo_inputs(1)
    A = build_coo(row, col, val, n, num_cols=m, pad_to=1000,
                  pad_multiple=128, dtype=np.float64, device="cpu")
    J = jx_build_coo(row, col, val, n, num_cols=m, pad_to=1000)
    assert A.val.dtype == torch.float64 and A.nnz == len(row)
    np.testing.assert_array_equal(A.row.numpy(), np.asarray(J.row)[:J.nnz])
    np.testing.assert_allclose(A.val.numpy(), np.asarray(J.val)[:J.nnz])
    P = spmm.make_propagator(row, col, val, n, mode="segment", pad_to=512,
                             dtype=np.float32, device="cpu")
    x = np.random.default_rng(2).standard_normal((n, 3)).astype(np.float32)
    want = jx_spmm.make_propagator(row, col, val, n, mode="segment",
                                   pad_to=512)(jnp.asarray(x))
    np.testing.assert_allclose(P(torch.from_numpy(x)).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["mxu", "segment"])
def test_dual_propagator_without_transpose_matches_jax(mode):
    row, col, va, n, m = coo_inputs(3)
    vb = np.random.default_rng(4).standard_normal(len(row)).astype(
        np.float32)
    D = spmm.dual_propagator(row, col, va, vb, n, m, mode=mode,
                             with_transpose=False, device="cpu")
    J = jx_spmm.dual_propagator(row, col, va, vb, n, m, mode="segment",
                                with_transpose=False)
    assert D.transposed is None and J.transposed is None
    x = np.random.default_rng(5).standard_normal((m, 6)).astype(np.float32)
    got = spmm.dual_spmm_stacked(D, torch.from_numpy(x))
    want = jx_spmm.dual_spmm_stacked(J, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="with_transpose=False"):
        spmm.dual_spmm_stacked(
            D, torch.from_numpy(x).requires_grad_()).sum().backward()


def regression(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((64, 4)).astype(np.float32)
    y = (x @ np.array([1.0, -2.0, 0.5, 0.0], np.float32)).astype(np.float32)
    w0 = rng.standard_normal(4).astype(np.float32)
    return x, y, w0


def port_linear(w0):
    lin = torch.nn.Linear(4, 1, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w0)[None])
    return lin


@pytest.mark.parametrize("optimizer", ["default", "factory"])
def test_positional_trainer_matches_jax(optimizer):
    """``Trainer(loss_fn, lr, weight_decay, optimizer, rng)`` binds as
    JAX's does: the seed given fifth is the loss function's generator
    (JAX: its key), and ``optimizer`` replaces the default Adam."""
    x, y, w0 = regression()
    lr, wd = 5e-2, 1e-2

    def jloss(p, key):
        return jnp.mean((jnp.asarray(x) @ p["w"] - jnp.asarray(y)) ** 2)

    jopt = (None if optimizer == "default" else
            optax.chain(optax.add_decayed_weights(wd), optax.adam(lr)))
    jt = JxTrainer(jloss, lr, wd, jopt, 7)
    js = jt.init({"w": jnp.asarray(w0)})
    jlosses = [jt.step(js) for _ in range(5)]

    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    gens = []

    def loss(m, gen):
        gens.append(gen)
        return ((m(xt)[:, 0] - yt) ** 2).mean()

    opt = None if optimizer == "default" else adam(lr, wd)
    tr = Trainer(loss, lr, wd, opt, 7, device="cpu")
    assert tr.generator is not None and tr.generator.initial_seed() == 7
    st = tr.init(port_linear(w0))
    losses = [tr.step(st) for _ in range(5)]
    assert all(g is tr.generator for g in gens)
    # torch's and optax's Adam round in other places (as in
    # tests/test_torch_train.py)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(st.params.weight.detach().numpy()[0],
                               np.asarray(js.params["w"]), rtol=1e-4,
                               atol=1e-5)


def test_trainer_refuses_decoupled_with_an_optimizer():
    with pytest.raises(ValueError, match="decoupled"):
        Trainer(lambda m: 0, 1e-2, 0.0, adam(1e-2), decoupled=True,
                device="cpu")


@pytest.mark.parametrize("best_on_host", [True, False])
def test_fit_keeps_the_best_parameters_as_jax_does(best_on_host):
    x, y, w0 = regression(1)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)

    def jloss(p):
        return jnp.mean((jnp.asarray(x) @ p["w"] - jnp.asarray(y)) ** 2)

    def jmetric(p):
        return -float(jloss(p))

    jt = JxTrainer(jloss, lr=1e-1)
    js = jt.fit(jt.init({"w": jnp.asarray(w0)}), tuple, epochs=40,
                eval_fn=jmetric, eval_every=5, best_on_host=best_on_host)

    def loss(m):
        return ((m(xt)[:, 0] - yt) ** 2).mean()

    tr = Trainer(loss, lr=1e-1, device="cpu")
    st = tr.fit(tr.init(port_linear(w0)), tuple, epochs=40,
                eval_fn=lambda m: -float(loss(m)), eval_every=5,
                best_on_host=best_on_host)
    np.testing.assert_allclose(st.history["metric"], js.history["metric"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(st.best_metric, js.best_metric, rtol=1e-4)
    best = st.best_params["weight"]
    assert best.device == st.params.weight.device
    assert best.data_ptr() != st.params.weight.data_ptr()
    np.testing.assert_allclose(best.numpy()[0],
                               np.asarray(jax.device_get(
                                   js.best_params["w"])),
                               rtol=1e-4, atol=1e-6)
