"""Port checkpoints, timing and the masked loss on the CPU: a restored
state continues exactly as the saved one would have; ``time_fn`` and
``trace`` round trips; ``masked_nll`` against the JAX package's."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_signed_directed_tpu.train.scan_trainer import (
    masked_nll as jx_masked_nll)

from pytorch_geometric_signed_directed_tpu_torch.train import (
    Trainer, edges_per_second, masked_nll, restore_checkpoint,
    save_checkpoint, time_fn, trace)

from test_torch_worker_memory import release_memory  # noqa: F401


def problem(seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(64, 5, generator=gen)
    y = torch.randint(0, 3, (64,), generator=gen)
    model = torch.nn.Sequential(torch.nn.Linear(5, 8), torch.nn.ReLU(),
                                torch.nn.Linear(8, 3))

    def loss_fn(m):
        return torch.nn.functional.cross_entropy(m(x), y)

    return model, Trainer(loss_fn, lr=1e-2, weight_decay=1e-3, device="cpu")


def test_checkpoint_round_trip(tmp_path):
    torch.manual_seed(0)
    model, tr = problem()
    state = tr.init(model)
    for _ in range(3):
        tr.step(state)
    target = save_checkpoint(str(tmp_path), state)
    assert os.path.basename(target) == "step_3"
    ahead = [tr.step(state) for _ in range(2)]

    torch.manual_seed(1)                     # other initial weights
    fresh_model, tr2 = problem()
    fresh = restore_checkpoint(str(tmp_path), tr2.init(fresh_model))
    assert fresh.step == 3
    again = [tr2.step(fresh) for _ in range(2)]
    assert again == ahead
    for a, b in zip(model.state_dict().values(),
                    fresh_model.state_dict().values()):
        assert torch.equal(a, b)


def test_restore_takes_the_latest_step(tmp_path):
    model, tr = problem()
    state = tr.init(model)
    for step in (2, 10, 9):
        save_checkpoint(str(tmp_path), state, step=step)
    assert sorted(os.listdir(tmp_path)) == ["step_10", "step_2", "step_9"]
    assert restore_checkpoint(str(tmp_path), state).step == 10
    assert restore_checkpoint(str(tmp_path / "step_2"), state).step == 2


def test_restore_without_checkpoints_raises(tmp_path):
    model, tr = problem()
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        restore_checkpoint(str(tmp_path), tr.init(model))


def test_time_fn_counts_its_calls():
    calls = []
    secs = time_fn(lambda v: calls.append(v), 3, iters=7, warmup=2)
    assert calls == [3] * 9
    assert secs >= 0.0
    eps = edges_per_second(lambda: sum(range(1000)), 500, iters=3)
    assert eps > 0.0


def test_trace_writes_a_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert prof is not None
    assert any(f.endswith(".json") or f.endswith(".json.gz")
               for f in os.listdir(tmp_path))


def test_masked_nll_matches_jax():
    rng = np.random.default_rng(0)
    logp = np.log(rng.dirichlet(np.ones(4), 30)).astype(np.float32)
    y = rng.integers(0, 4, 30)
    for mask in (rng.random(30) < 0.4, np.zeros(30, bool)):
        m = mask.astype(np.float32)
        got = masked_nll(torch.from_numpy(logp), torch.from_numpy(y),
                         torch.from_numpy(m))
        want = jx_masked_nll(jnp.asarray(logp), jnp.asarray(y),
                             jnp.asarray(m))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
