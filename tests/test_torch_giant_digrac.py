"""``scripts/giant_digrac_torch.py`` against ``scripts/giant_digrac.py`` on
the CPU, at a small size with the layout knobs of both packages set low,
so that every operator is column-split and streamed (at 2.4M nodes
all are split, and all but A and Aᵀ streamed):
the printed JSON lines and loss trajectories of ``main``, pair and fused,
from the same initial weights; the graph generator against
``scripts/bench_giant.py``'s; the imbalance loss's streamed dual against
its pair and the JAX loss."""
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_signed_directed_tpu import graph as jx_graph
from pytorch_geometric_signed_directed_tpu.nn import (
    DIGRAC_node_clustering as JxDIGRAC)
from pytorch_geometric_signed_directed_tpu.ops import spmm as jx_spmm
from pytorch_geometric_signed_directed_tpu.ops.pallas import scatter_mxu
from pytorch_geometric_signed_directed_tpu.utils import (
    Prob_Imbalance_Loss as JxImbalance)

from pytorch_geometric_signed_directed_tpu_torch import graph
from pytorch_geometric_signed_directed_tpu_torch.convert import (
    state_dict_from_jax)
from pytorch_geometric_signed_directed_tpu_torch.ops import layout, spmm
from pytorch_geometric_signed_directed_tpu_torch.utils import (
    Prob_Imbalance_Loss)

from test_torch_worker_memory import release_memory  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, E, K, HOP, HIDDEN, STEPS, SEED = 3000, 20_000, 5, 2, 32, 5, 0
# every operator split (64 hot columns) and streamed (blocks of 8,000)
KNOBS = dict(COL_SPLIT_MIN_COLS=100, GATHER_FAST_ROWS=64,
             COL_SPLIT_MIN_COVERAGE=0.0, STREAM_THRESHOLD_EDGES=1000,
             STREAM_BLOCK_EDGES=8000)
# both scripts round every message to bf16 and sum in float32, in other
# orders: a message on either side of a bf16 rounding boundary moves a
# loss of ~1 by ~1e-4 over five Adam steps; the printed losses carry 4
# decimals
LOSS_TOL = dict(rtol=0, atol=1e-3)
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def scripts():
    return load("giant_digrac_torch"), load("giant_digrac"), \
        load("bench_giant")


@pytest.fixture
def small_layouts(monkeypatch):
    """The layout knobs and the dense tier's bound low on both packages;
    afterwards both packages' process-wide precision and message type
    (which the scripts set) back to the defaults."""
    for k, v in KNOBS.items():
        monkeypatch.setattr(layout, k, v)
        monkeypatch.setattr(scatter_mxu, k, v)
    monkeypatch.setattr(spmm, "_DENSE_AUTO_MAX_NODES", 100)
    monkeypatch.setattr(jx_spmm, "_DENSE_AUTO_MAX_NODES", 100)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    for pkg in (spmm, jx_spmm):
        pkg.set_matmul_precision("highest")
        pkg.set_message_dtype(None)


def json_line(out):
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


def trajectory(out):
    line = [ln for ln in out.splitlines()
            if ln.startswith("loss trajectory:")][-1]
    return [float(v) for v in line.split(":")[1].split()]


def test_powerlaw_digraph_is_bench_giants(scripts):
    port, _, bench = scripts
    for args in ((2000, 15_000, 1.0, 0), (500, 4000, 0.8, 3)):
        for a, b in zip(port.powerlaw_digraph(*args),
                        bench.powerlaw_digraph(*args)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fused", [False, True], ids=["pair", "fused"])
def test_main_matches_the_jax_script(fused, scripts, small_layouts,
                                     monkeypatch, capsys):
    port, jx_script, _ = scripts
    # the JAX script's initial weights: its model under PRNGKey(seed)
    row, col = port.powerlaw_digraph(N, E, 1.0, SEED)
    ei = np.vstack([row, col])
    w = np.ones(len(row), np.float32)
    x = jx_graph.in_out_degree(ei, N, edge_weight=w)
    x = jnp.asarray(x / max(x.max(), 1.0))
    jP = jx_graph.rw_norm_propagator(ei, w, N, mode="dense")
    jparams = JxDIGRAC(num_features=2, hidden=HIDDEN, nclass=K,
                       fill_value=0.5, hop=HOP).init(
        jax.random.PRNGKey(SEED), jP, jP, x)
    make_model = port.make_model

    def from_jax(*args):
        model = make_model(*args)
        model.load_state_dict(state_dict_from_jax(jax.device_get(jparams)))
        return model

    monkeypatch.setattr(port, "make_model", from_jax)
    kw = dict(n=N, e=E, k=K, hop=HOP, hidden=HIDDEN, steps=STEPS,
              seed=SEED, fused=fused)

    assert jx_script.main(**kw) == 0
    want_out = capsys.readouterr().out
    report = {}
    assert port.main(device="cpu", report=report, **kw) == 0
    got_out = capsys.readouterr().out
    # the script set bf16 messages and "default" precision, process-wide
    assert spmm.get_message_dtype() == torch.bfloat16
    assert spmm.get_matmul_precision() == "default"

    ops = [port.kernel_view(op) for _, op in port.named_operators(
        *report["ops"])]
    assert len(ops) == (2 if fused else 4)
    for d in ops + [d.transposed for d in ops]:
        assert d.streamed and d.hot_ids is not None and len(d.blocks) >= 2
    assert "split+streamed" in got_out and "host seconds: graph" in got_out
    assert "compile+step0" in got_out and "propagators built" in got_out
    assert all(n == 0 for step in report["launches"] for n in step.values())

    got, want = json_line(got_out), json_line(want_out)
    assert set(got) == set(want) | {"power_limit"}
    for k in ("metric", "fused", "n", "e", "k", "hop", "decreased"):
        assert got[k] == want[k], k
    assert got["backend"] == "cpu" and got["power_limit"] is None
    assert got["decreased"] is True
    for k in ("loss_first", "loss_last"):
        np.testing.assert_allclose(got[k], want[k], **LOSS_TOL)
    np.testing.assert_allclose(trajectory(got_out), trajectory(want_out),
                               **LOSS_TOL)
    np.testing.assert_allclose(report["losses"], trajectory(want_out),
                               **LOSS_TOL)


def test_imbalance_dual_matches_pair_and_jax(small_layouts):
    """The loss's volumes A P and Aᵀ P: one streamed 2K=10 apply of the
    A dual against the streamed pair at W=5 and the JAX loss, in f32."""
    row, col = load("giant_digrac_torch").powerlaw_digraph(N, E, 1.0, 1)
    ei = np.vstack([row, col])
    w = np.random.default_rng(1).random(len(row)).astype(np.float32)
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((N, K)).astype(np.float32)
    P = torch.softmax(torch.from_numpy(logits), dim=1)
    dual = graph.adj_dual_propagator(ei, w, N, device="cpu")
    pair = (graph.norm_propagator(ei[[1, 0]], w, N, device="cpu"),
            graph.norm_propagator(ei, w, N, device="cpu"))
    for d in (dual, pair[0].csr, pair[1].csr):
        assert d.streamed and d.hot_ids is not None
    jpair = (jx_graph.norm_propagator(ei[[1, 0]], w, N),
             jx_graph.norm_propagator(ei, w, N))
    jP = jax.nn.softmax(jnp.asarray(logits), axis=1)
    for threshold in ("sort", "std", "naive"):
        loss = Prob_Imbalance_Loss(K)
        got_dual = loss(P, dual, K, "vol_sum", threshold)
        got_pair = loss(P, pair, K, "vol_sum", threshold)
        want = JxImbalance(K)(jP, jpair, K, "vol_sum", threshold)
        np.testing.assert_allclose(float(got_dual), float(got_pair),
                                   **F32_TOL)
        np.testing.assert_allclose(float(got_dual), float(want), **F32_TOL)
