"""Port Trainer vs the JAX Trainer: Adam with coupled L2, the same steps
from the same carried-over weights."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_geometric_signed_directed_tpu.nn import (
    MagNet_node_classification as JxMagNetNode)
from pytorch_geometric_signed_directed_tpu.spectral import (
    magnet_propagators as jx_magnet_propagators)
from pytorch_geometric_signed_directed_tpu.train import Trainer as JxTrainer

from pytorch_geometric_signed_directed_tpu_torch.convert import (
    state_dict_from_jax)
from pytorch_geometric_signed_directed_tpu_torch.data import DSBM
from pytorch_geometric_signed_directed_tpu_torch.graph import in_out_degree
from pytorch_geometric_signed_directed_tpu_torch.nn import (
    MagNet_node_classification)
from pytorch_geometric_signed_directed_tpu_torch.spectral import (
    magnet_propagators)
from pytorch_geometric_signed_directed_tpu_torch.train import (
    Trainer, train_full_batch)
from pytorch_geometric_signed_directed_tpu_torch.utils import (
    meta_graph_generation)

from test_torch_worker_memory import release_memory  # noqa: F401


def slice_problem(n=300, seed=0):
    """The slice's configuration (DSBM, degree features, MagNet K=2,
    hidden 32, 2 layers) at a small N."""
    F = meta_graph_generation("cyclic", 5, 0.05, False)
    A, labels = DSBM(n, 5, 30 / n * 5 / 2, F,
                     rng=np.random.default_rng(seed))
    ei = np.vstack(A.nonzero())
    w = A.tocoo().data
    x = in_out_degree(ei, n, edge_weight=w)
    return ei, w, (x / max(x.max(), 1.0)).astype(np.float32), labels


@pytest.mark.parametrize("mode", ["dense", "mxu"])
def test_five_steps_match_jax_trainer(mode):
    n = 300
    ei, w, x, y = slice_problem(n)
    lap = magnet_propagators(ei, w, q=0.25, num_nodes=n, mode=mode,
                             device="cpu")
    jlap = jx_magnet_propagators(ei, w, q=0.25, num_nodes=n, mode=mode)
    kw = dict(num_features=2, hidden=32, K=2, label_dim=5, activation=True,
              layer=2)
    jmodel = JxMagNetNode(**kw)
    params = jmodel.init(jax.random.PRNGKey(0), x, x, jlap)

    def jloss(p):
        logp = jmodel.apply(p, x, x, jlap)
        return -jnp.mean(logp[jnp.arange(n), y])

    jt = JxTrainer(jloss, lr=5e-3, weight_decay=5e-4)
    js = jt.init(params)
    jlosses = [jt.step(js) for _ in range(5)]

    model = MagNet_node_classification(**kw, device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)

    def loss_fn(m):
        return torch.nn.functional.nll_loss(m(xt, xt, lap), yt)

    tr = Trainer(loss_fn, lr=5e-3, weight_decay=5e-4, device="cpu")
    st = tr.init(model)
    losses = [tr.step(st) for _ in range(5)]

    assert st.step == 5
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-5)
    want = state_dict_from_jax(jax.device_get(js.params))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_weight_decay_is_coupled_l2():
    """Trainer(weight_decay=wd) is Adam on the gradient g + wd*p (coupled
    L2, as torch Adam), not decoupled AdamW — the contract of the JAX
    package's trainer test."""
    w0, wd, lr = 2.0, 0.1, 0.05

    class W(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.tensor([w0]))

    t = Trainer(lambda m: (m.w ** 2).sum(), lr=lr, weight_decay=wd,
                device="cpu")
    s = t.init(W())
    t.step(s)
    ref = optax.adam(lr)
    g = {"w": jnp.asarray([2 * w0 + wd * w0])}
    upd, _ = ref.update(g, ref.init(g))
    expect = optax.apply_updates({"w": jnp.asarray([w0])}, upd)
    np.testing.assert_allclose(s.params.w.detach().numpy(),
                               np.asarray(expect["w"]), rtol=1e-6)


def test_fit_converges_and_keeps_best():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((64, 4)).astype(np.float32))
    y = x @ torch.tensor([1.0, -2.0, 0.5, 0.0])
    lin = torch.nn.Linear(4, 1)

    def loss_fn(m):
        return ((m(x)[:, 0] - y) ** 2).mean()

    state = train_full_batch(loss_fn, lin, tuple, epochs=200, lr=1e-1,
                             eval_fn=lambda m: -float(loss_fn(m)),
                             eval_every=10, device="cpu")
    assert state.step == 200
    assert state.history["loss"][-1] < 1e-2
    assert set(state.best_params) == {"weight", "bias"}


def test_rng_threads_a_generator():
    seen = []

    def loss_fn(m, gen):
        seen.append(torch.rand((), generator=gen).item())
        return (m.weight ** 2).sum()

    tr = Trainer(loss_fn, lr=1e-2, rng=0, device="cpu")
    st = tr.init(torch.nn.Linear(2, 1))
    tr.step(st)
    tr.step(st)
    assert seen[0] != seen[1]
    tr2 = Trainer(loss_fn, lr=1e-2, rng=0, device="cpu")
    tr2.step(tr2.init(torch.nn.Linear(2, 1)))
    assert seen[2] == seen[0]
