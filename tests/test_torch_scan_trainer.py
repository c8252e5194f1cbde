"""The port's ``scan_node_training`` against the JAX package's on the CPU:
MagNet on the kernel ("mxu") tier, so the CSR path with its row plans
runs, from the JAX-initialized weights of each split carried over by
``state_dict_from_jax``, Adam with coupled L2 as
``scripts/reference_protocol_magnet.py`` trains it.  On the CPU the
port's epochs run eagerly (the captured run needs a card:
tests/test_torch_cuda.py)."""
import jax
import numpy as np
import optax
import pytest
import torch

from pytorch_geometric_signed_directed_tpu.nn import (
    MagNet_node_classification as JxMagNetNode)
from pytorch_geometric_signed_directed_tpu.parallel import (
    make_mesh as jx_make_mesh,
    shard_magnet_laplacian as jx_shard_magnet_laplacian)
from pytorch_geometric_signed_directed_tpu.spectral import (
    magnet_propagators as jx_magnet_propagators,
    magnetic_template as jx_magnetic_template)
from pytorch_geometric_signed_directed_tpu.train import (
    masked_nll as jx_masked_nll,
    scan_node_training as jx_scan_node_training)

from pytorch_geometric_signed_directed_tpu_torch.convert import (
    state_dict_from_jax)
from pytorch_geometric_signed_directed_tpu_torch.nn import (
    MagNet_node_classification)
from pytorch_geometric_signed_directed_tpu_torch.parallel import (
    make_mesh, shard_magnet_laplacian)
from pytorch_geometric_signed_directed_tpu_torch.spectral import (
    magnet_propagators, magnetic_template)
from pytorch_geometric_signed_directed_tpu_torch.train import (
    SplitRun, adam, scan_node_training)

from test_torch_worker_memory import release_memory  # noqa: F401

N, SPLITS, EPOCHS, LR, WD = 200, 2, 20, 1e-2, 5e-4
# 20 Adam steps of float32 sums taken in other orders: the final losses
# agree to about 1e-6; the MagNet parity tests' 2e-4 bounds them
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
KEYS = ("best_val", "best_test", "final_test", "final_loss")


def problem(seed=0):
    rng = np.random.default_rng(seed)
    row, col = rng.integers(0, N, 1400), rng.integers(0, N, 1400)
    keep = row != col
    ei = np.stack([row[keep], col[keep]])
    x = rng.random((N, 2)).astype(np.float32)
    # labels that follow the features a little, so training has a signal
    y = (x[:, 0] * 3).astype(np.int64) % 3
    noise = rng.random(N) < 0.3
    y[noise] = rng.integers(0, 3, int(noise.sum()))
    masks = (rng.random((3, SPLITS, N)) < 0.35).astype(np.float32)
    return ei, np.ones(ei.shape[1]), x, y, masks


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Epochs of tiny ops: beside the suite's other parallel workers,
    torch's intra-op threads contend for the cores (a 0.5 s test took
    ~40 s so); one thread keeps each test at its own cost."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_model(dropout=0.0, seed=0):
    return MagNet_node_classification(
        num_features=2, hidden=8, K=1, label_dim=3, activation=True,
        layer=2, dropout=dropout, device="cpu",
        generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def setup():
    ei, w, x, y, masks = problem()
    lap = magnet_propagators(ei, w, q=0.25, num_nodes=N, mode="mxu",
                             device="cpu")
    assert lap.dual is not None and lap.dual.row_split is not None
    xt = torch.from_numpy(x)

    def apply_fn(model, training, generator):
        return model(xt, xt, lap, training, generator)

    return dict(ei=ei, w=w, x=x, y=y, masks=masks, apply_fn=apply_fn)


def test_matches_jax_scan_node_training(setup):
    ei, w, x, y, masks = (setup[k] for k in ("ei", "w", "x", "y", "masks"))
    jlap = jx_magnet_propagators(ei, w, q=0.25, num_nodes=N, mode="mxu")
    jmodel = JxMagNetNode(num_features=2, hidden=8, K=1, label_dim=3,
                          activation=True, layer=2)
    tx = optax.chain(optax.add_decayed_weights(WD), optax.adam(LR))
    want = jx_scan_node_training(
        lambda p, training, key: jmodel.apply(p, x, x, jlap),
        lambda key: jmodel.init(key, x, x, jlap), y, *masks,
        epochs=EPOCHS, tx=tx, seed=0)
    # the JAX function's own keys: split(PRNGKey(seed), S)
    keys = jax.random.split(jax.random.PRNGKey(0), SPLITS)

    def init_fn(split):
        model = port_model()
        model.load_state_dict(state_dict_from_jax(jax.device_get(
            jmodel.init(keys[split], x, x, jlap))))
        return model

    got = scan_node_training(setup["apply_fn"], init_fn, y, *masks,
                             epochs=EPOCHS, tx=adam(LR, WD), device="cpu")
    assert set(got) == set(KEYS)
    for k in KEYS:
        assert got[k].shape == (SPLITS,) and got[k].dtype == np.float32
    for k in ("best_val", "best_test", "final_test"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               **LOSS_TOL)
    # the selection started from -1 and some epoch was chosen
    assert np.all(got["best_val"] >= 0)


def test_a_split_gives_the_same_alone_or_second(setup):
    """Nothing of split 0 (optimizer, selection state) leaks into split
    1: split 1 run second equals the same split run alone."""
    y, masks = setup["y"], setup["masks"]
    both = scan_node_training(setup["apply_fn"],
                              lambda s: port_model(seed=10 + s), y, *masks,
                              epochs=EPOCHS, tx=adam(LR, WD), device="cpu")
    alone = scan_node_training(setup["apply_fn"],
                               lambda s: port_model(seed=11 + s), y,
                               *masks[:, 1:], epochs=EPOCHS,
                               tx=adam(LR, WD), device="cpu")
    for k in KEYS:
        np.testing.assert_array_equal(both[k][1:], alone[k], err_msg=k)


def test_stochastic_mode_repeats_for_one_seed(setup):
    y, masks = setup["y"], setup["masks"]

    def run(seed, stochastic=True):
        return scan_node_training(
            setup["apply_fn"], lambda s: port_model(dropout=0.5, seed=s), y,
            *masks, epochs=8, tx=adam(LR, WD), seed=seed,
            stochastic=stochastic, device="cpu")

    first, second = run(3), run(3)
    for k in KEYS:
        np.testing.assert_array_equal(first[k], second[k], err_msg=k)
    # dropout was drawn: another seed, or none, trains otherwise
    assert not np.array_equal(first["final_loss"], run(4)["final_loss"])
    assert not np.array_equal(first["final_loss"],
                              run(3, stochastic=False)["final_loss"])


def test_split_run_records_every_epoch(setup):
    """The per-epoch losses that a captured run is held to on the card:
    the eager epochs write each loss in place, the last is final_loss,
    and they equal a plain loop of the same steps."""
    y = torch.from_numpy(setup["y"])
    mask_tr, mask_val, mask_te = (torch.from_numpy(m[0])
                                  for m in setup["masks"])
    run = SplitRun(setup["apply_fn"], port_model(seed=5), adam(LR, WD), y,
                   mask_tr, mask_val, mask_te, epochs=6).run(captured=False)
    model = port_model(seed=5)
    opt = torch.optim.Adam(model.parameters(), lr=LR, weight_decay=WD)
    losses = []
    for _ in range(6):
        opt.zero_grad()
        logp = setup["apply_fn"](model, True, None)
        loss = -(logp[torch.arange(N), y] * mask_tr).sum() / mask_tr.sum()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    np.testing.assert_array_equal(run.losses.numpy(),
                                  np.float32(losses))
    assert float(run.results()[3]) == losses[-1]
    assert run.launches == {}         # CPU tensors launch no kernel
    with pytest.raises(ValueError, match="at least one epoch"):
        SplitRun(setup["apply_fn"], port_model(), adam(LR), y, mask_tr,
                 mask_val, mask_te, epochs=0)


@pytest.mark.parametrize("decoupled", [False, True])
def test_adam_factory_matches_optax(decoupled):
    """``adam`` is optax's ``chain(add_decayed_weights, adam)`` (coupled)
    or ``adamw`` (decoupled) over five steps of fixed gradients."""
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal((4, 3)).astype(np.float32)
    grads = rng.standard_normal((5, 4, 3)).astype(np.float32)
    tx = (optax.adamw(LR, weight_decay=0.1) if decoupled else
          optax.chain(optax.add_decayed_weights(0.1), optax.adam(LR)))
    p = jax.numpy.asarray(p0)
    state = tx.init(p)
    for g in grads:
        upd, state = tx.update(jax.numpy.asarray(g), state, p)
        p = optax.apply_updates(p, upd)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = adam(LR, 0.1, decoupled=decoupled)([param])
    assert isinstance(opt, torch.optim.AdamW if decoupled
                      else torch.optim.Adam)
    assert not opt.defaults["capturable"]  # CPU parameters
    for g in grads:
        param.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(p),
                               rtol=1e-6, atol=1e-6)


# --- trainable q: the template's applies through scan_node_training -------

TQ_EPOCHS = 8
# q's gradient is a sum over every edge whose terms cancel: on split 1 it
# changes sign from epoch to epoch (|g| from 3e-3 to 0.2), and Adam
# divides it by its running RMS, so float32 sums taken in other orders
# move q by ~1e-4 in 8 epochs; a tenth of one step of lr 1e-2 bounds it
Q_TOL = dict(rtol=0, atol=1e-3)


def tq_jax_model():
    return JxMagNetNode(num_features=2, hidden=8, K=1, label_dim=3,
                        activation=True, layer=2, trainable_q=True)


def jax_final_q(jmodel, jparams, jlap, x, y, train_masks, tx):
    """q of each layer of each split after ``TQ_EPOCHS`` steps of JAX's
    scan body (the loss, its gradient and the optax update): the JAX
    function returns no parameters."""
    @jax.jit
    def step(p, s, mask_tr):
        def loss_fn(pp):
            return jx_masked_nll(jmodel.apply(pp, x, x, jlap), y, mask_tr)

        u, s = tx.update(jax.grad(loss_fn)(p), s, p)
        return optax.apply_updates(p, u), s

    qs = []
    for params, mask_tr in zip(jparams, train_masks):
        opt_state = tx.init(params)
        for _ in range(TQ_EPOCHS):
            params, opt_state = step(params, opt_state, mask_tr)
        sd = state_dict_from_jax(jax.device_get(params))
        qs.append([float(sd[f"convs.{i}.q"].reshape(())) for i in range(2)])
    return qs


@pytest.mark.parametrize("sharded", [False, True], ids=["flat", "sharded"])
def test_trainable_q_matches_jax_scan_node_training(sharded, setup):
    """MagNet with trainable q on the mxu template: flat (K1's pair
    forward, K1 dx) and sharded on the 8-shard CPU mesh (K1 a shard
    forward, K3 a shard backward), through both packages'
    ``scan_node_training`` from JAX's initial weights: the losses, the
    selections and the trained q."""
    ei, w, x, y, masks = (setup[k] for k in ("ei", "w", "x", "y", "masks"))
    jtmpl = jx_magnetic_template(ei, w, num_nodes=N, mode="mxu")
    tmpl = magnetic_template(ei, w, num_nodes=N, mode="mxu", device="cpu")
    jmesh = jx_make_mesh(8)
    if sharded:
        jtmpl = jx_shard_magnet_laplacian(jtmpl, jmesh)
        tmpl = shard_magnet_laplacian(tmpl, make_mesh(8, device="cpu"))
        assert tmpl.mode == jtmpl.mode == "mxu_sharded"
    jmodel = tq_jax_model()
    tx = optax.chain(optax.add_decayed_weights(WD), optax.adam(LR))
    keys = jax.random.split(jax.random.PRNGKey(0), SPLITS)
    with jmesh:
        want = jx_scan_node_training(
            lambda p, training, key: jmodel.apply(p, x, x, jtmpl),
            lambda key: jmodel.init(key, x, x, jtmpl), y, *masks,
            epochs=TQ_EPOCHS, tx=tx, seed=0)
        jparams = [jmodel.init(k, x, x, jtmpl) for k in keys]
        want_q = jax_final_q(jmodel, jparams, jtmpl, x, y, masks[0], tx)

    xt = torch.from_numpy(x)
    models = []

    def init_fn(split):
        model = MagNet_node_classification(
            num_features=2, hidden=8, K=1, label_dim=3, activation=True,
            layer=2, trainable_q=True, device="cpu")
        model.load_state_dict(state_dict_from_jax(jax.device_get(
            jparams[split])))
        models.append(model)
        return model

    got = scan_node_training(
        lambda m, training, gen: m(xt, xt, tmpl, training, gen), init_fn, y,
        *masks, epochs=TQ_EPOCHS, tx=adam(LR, WD), device="cpu")
    for k in ("best_val", "best_test", "final_test"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               **LOSS_TOL)
    got_q = [[float(c.q.detach()) for c in m.convs] for m in models]
    np.testing.assert_allclose(got_q, want_q, **Q_TOL)
    # q left its starting value 0.25 in every layer of every split
    assert all(abs(q - 0.25) > 1e-3 for qs in got_q for q in qs)
