"""The experiments that read real datasets, port vs the JAX package, on
small graphs written in each dataset's schema (``data.schema_files``):
the inputs each builds (features, operators and views, link splits,
signed embeddings and their samples) are bit-equal; five steps from
carried-over weights give the same losses for dgcn_node and
link_sign_prediction; ``run_link_sign_direction_tasks`` prints the JAX
module's lines for each method.  digcl_node's inputs and steps are in
tests/test_torch_experiments.py."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from pytorch_geometric_signed_directed_tpu import graph as jx_graph
from pytorch_geometric_signed_directed_tpu.data import load_real as jx_load
from pytorch_geometric_signed_directed_tpu.experiments import (
    run_link_sign_direction_tasks as jx_lsdt)
from pytorch_geometric_signed_directed_tpu.experiments.dgcn_node import (
    build_propagators as jx_dgcn_propagators)
from pytorch_geometric_signed_directed_tpu.graph import (
    in_out_degree as jx_in_out_degree)
from pytorch_geometric_signed_directed_tpu.nn import (
    DGCN_node_classification as JxDGCNNode, SGCN as JxSGCN)
from pytorch_geometric_signed_directed_tpu.nn.signed.sgcn import (
    prepare_sgcn_inputs as jx_prepare_sgcn_inputs)
from pytorch_geometric_signed_directed_tpu.spectral import (
    appr_directed_adj as jx_appr_directed_adj,
    cal_fast_appr as jx_cal_fast_appr,
    second_directed_adj as jx_second_directed_adj)
from pytorch_geometric_signed_directed_tpu.train import Trainer as JxTrainer
from pytorch_geometric_signed_directed_tpu.utils import (
    link_class_split as jx_link_class_split,
    negative_sampling as jx_negative_sampling,
    structured_negative_sampling as jx_structured_negative_sampling)

from pytorch_geometric_signed_directed_tpu_torch.convert import (
    state_dict_from_jax)
from pytorch_geometric_signed_directed_tpu_torch.data import schema_files
from pytorch_geometric_signed_directed_tpu_torch.experiments import (
    _directed_node, dgcn_node, digcl_link, digcl_node, digcn_inception_node,
    digcn_node, run_link_sign_direction_tasks, run_link_sign_prediction)

from test_torch_worker_memory import release_memory  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-4)


def assert_same(a, b, path="out"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype, (path, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=path)


def template(text):
    return [re.sub(r"\d+(\.\d+)?", "#", line) for line in
            text.strip().splitlines()]


@pytest.fixture(scope="module")
def schema_dir(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("datasets"))
    schema_files.write_citation(r, "cora_ml", num_nodes=640,
                                num_edges=2200, num_classes=3,
                                num_features=24)
    schema_files.write_telegram(r, num_nodes=60, num_edges=600,
                                num_classes=3)
    schema_files.write_signed_csv(r, num_nodes=150, num_pos=700, num_neg=150)
    return r


@pytest.fixture(autouse=True)
def in_schema_dir(schema_dir, monkeypatch):
    monkeypatch.chdir(schema_dir)
    monkeypatch.setenv("PGSD_TPU_NO_CACHE", "1")
    monkeypatch.delenv("PGSD_TPU_DATA", raising=False)
    monkeypatch.setattr(jx_load, "_SEARCH_PATHS", ["", "datasets"])


def load(model, params):
    model.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    return model


def jx_view(alpha, edge_index, n, w):
    ei, v = jx_cal_fast_appr(alpha, edge_index, n, w)
    return jx_graph.gcn_norm_propagator(ei, v, n, mode="dense")


# --- digcl_node and digcl_link ---------------------------------------------

def test_digcl_node_split_runs_and_probes():
    args = digcl_node.parser().parse_args(["--epochs", "3"])
    inputs = digcl_node.build_inputs(args, "cpu")
    r = digcl_node.train_split(args, inputs, 0)
    assert len(r["losses"]) == 3 and np.all(np.isfinite(r["losses"]))
    assert 0.0 <= r["acc"] <= 1.0
    assert set(r["host_seconds"]) == {"views", "probe"}
    # the view cache is shared by the splits
    n_views = len(inputs.views)
    digcl_node.train_split(args, inputs, 1)
    assert len(inputs.views) == n_views


def test_digcl_link_inputs_bit_equal():
    args = digcl_link.parser().parse_args(["--dataset", "telegram",
                                           "--epochs", "6"])
    got = digcl_link.build_inputs(args, "cpu")
    data = jx_load.load_directed_real_data("telegram", name="telegram")
    datasets = jx_link_class_split(data, splits=2, prob_val=0.15,
                                   prob_test=0.05, task="direction", seed=0)
    assert_same(got.datasets, datasets)
    s = digcl_link.split_inputs(args, got, 1)
    g, w, n = datasets[1]["graph"], datasets[1]["weights"], data.num_nodes
    assert_same(s.x.numpy(), np.asarray(jx_in_out_degree(g, n), np.float32))
    assert_same(s.P1.dense.numpy(), np.asarray(jx_view(0.1, g, n, w).dense))
    a = digcl_node.curriculum_alpha("log", 4, 6)
    assert_same(s.views[4].dense.numpy(),
                np.asarray(jx_view(a, g, n, w).dense))
    assert len(s.cache) == 6


# --- the DGCN and DiGCN node experiments -----------------------------------

def jx_node_operators(name, data, w, n):
    if name == "dgcn_node":
        data.edge_weight = w
        return list(jx_dgcn_propagators(data, n))
    if name == "digcn_node":
        ei, v = jx_appr_directed_adj(0.1, data.edge_index, n,
                                     data.edge_weight)
        return [jx_graph.norm_propagator(ei, v, n)]
    return [jx_graph.norm_propagator(*jx_appr_directed_adj(
        0.1, data.edge_index, n, w), n),
        jx_graph.norm_propagator(*jx_second_directed_adj(
            data.edge_index, n, w), n)]


NODE = {"dgcn_node": dgcn_node, "digcn_node": digcn_node,
        "digcn_inception_node": digcn_inception_node}


@pytest.mark.parametrize("name", sorted(NODE))
@pytest.mark.parametrize("dataset", ["telegram", "cora_ml"])
def test_node_experiment_inputs_bit_equal(name, dataset):
    mod = NODE[name]
    args = mod.parser().parse_args(["--dataset", dataset])
    got = _directed_node.build_inputs(args, "cpu", mod)
    data = jx_load.load_directed_real_data(dataset, name=dataset)
    n = data.num_nodes
    w = np.asarray(data.edge_weight, np.float32)
    if name != "digcn_node":
        w = np.ones_like(w)  # --weights binary
        xd = jx_in_out_degree(data.edge_index, n, edge_weight=w)
        x = np.asarray(xd, np.float32) / max(float(xd.max()), 1.0)
    else:
        x = np.asarray(data.x, np.float32)
    assert_same(got.x.numpy(), x)
    ops = jx_node_operators(name, data, w, n)
    assert len(got.ops) == len(ops)
    for P, J in zip(got.ops, ops):
        assert P.mode == J.mode == "dense"
        assert_same(P.dense.numpy(), np.asarray(J.dense))
    assert got.label_dim == int(np.asarray(data.y).max()) + 1


def test_dgcn_node_five_steps_match_jax():
    args = dgcn_node.parser().parse_args(["--epochs", "5"])
    inputs = _directed_node.build_inputs(args, "cpu", dgcn_node)
    data = jx_load.load_directed_real_data("telegram", name="telegram")
    n = data.num_nodes
    w = np.ones(data.edge_index.shape[1], np.float32)
    ops = jx_node_operators("dgcn_node", data, w, n)
    x = inputs.x.numpy()
    y = jnp.asarray(data.y)
    mask = jnp.asarray(data.train_mask[:, 1].astype(np.float32))
    jm = JxDGCNNode(num_features=2, hidden=32, label_dim=3, dropout=0.5)
    params = jm.init(jax.random.PRNGKey(1), x, *ops)

    def jloss(p):
        logp = jm.apply(p, x, *ops)
        return (-logp[jnp.arange(n), y] * mask).sum() / mask.sum()

    tr = JxTrainer(jloss, lr=1e-2, weight_decay=5e-4)
    st = tr.init(params)
    jlosses = [tr.step(st) for _ in range(5)]
    model = load(dgcn_node.make_model(args, inputs, 1), params)
    r = _directed_node.train_split(args, inputs, 1, model)
    np.testing.assert_allclose(r["losses"], jlosses, **TOL)


# --- link_sign_prediction and the sign/direction tasks ----------------------

def jx_sign_inputs(seed=0):
    data = jx_load.load_signed_real_data("bitcoin_alpha")
    data.to_unweighted()
    datasets = jx_link_class_split(data, splits=1, task="sign", seed=seed,
                                   maintain_connect=False)
    tr = datasets[0]["train"]
    train_y = np.asarray(tr["label"])
    edge_index_s = np.concatenate(
        [np.asarray(tr["edges"]), np.where(train_y == 1, 1, -1)[:, None]],
        axis=1)
    return data, datasets, edge_index_s


def test_link_sign_prediction_inputs_bit_equal():
    args = run_link_sign_prediction.parser().parse_args([])
    got = run_link_sign_prediction.build_inputs(args, "cpu")
    data, datasets, edge_index_s = jx_sign_inputs()
    assert_same(got.data.edge_index, data.edge_index)
    assert_same(got.data.edge_weight, data.edge_weight)
    assert_same(got.train_edges, datasets[0]["train"]["edges"])
    assert_same(got.test_y, datasets[0]["test"]["label"])
    n = data.num_nodes
    pos, neg, emb, _, _ = jx_prepare_sgcn_inputs(n, edge_index_s, 32)
    assert_same(got.emb.model.x.detach().numpy(), np.asarray(emb,
                                                             np.float32))
    # the samples of each step: the first set is the JAX init's
    rng = np.random.default_rng(0)
    both = np.concatenate([pos, neg], axis=1)
    for _ in range(3):
        want = (jx_negative_sampling(both, n, rng=rng),
                jx_structured_negative_sampling(pos, n, rng=rng),
                jx_structured_negative_sampling(neg, n, rng=rng))
        s = got.emb.samples()
        assert_same(s[2], pos)
        assert_same(s[3], neg)
        for a, b in zip(s[4:], want):
            assert_same(a, b)


def test_link_sign_prediction_five_steps_match_jax():
    """SGCN on its own loss, AdamW (decoupled decay) beside optax's
    ``adamw``, each step on the same samples."""
    args = run_link_sign_prediction.parser().parse_args(["--epochs", "5"])
    inputs = run_link_sign_prediction.build_inputs(args, "cpu")
    data, _, edge_index_s = jx_sign_inputs()
    n = data.num_nodes
    pos, neg, emb, Pp, Pn = jx_prepare_sgcn_inputs(n, edge_index_s, 32)
    rng = np.random.default_rng(0)
    both = np.concatenate([pos, neg], axis=1)

    def largs():
        return (Pp, Pn, pos, neg, jx_negative_sampling(both, n, rng=rng),
                jx_structured_negative_sampling(pos, n, rng=rng),
                jx_structured_negative_sampling(neg, n, rng=rng))

    jm = JxSGCN(node_num=n, in_dim=32, out_dim=32, init_emb=emb)
    params = jm.init(jax.random.PRNGKey(0), *largs(), method=JxSGCN.loss)
    load(inputs.emb.model, params)
    tx = optax.adamw(1e-2, weight_decay=1e-5)
    opt = tx.init(params)
    jlosses = []
    for _ in range(5):
        a = largs()
        loss, grads = jax.value_and_grad(
            lambda p: jm.apply(p, *a, method=JxSGCN.loss))(params)
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        jlosses.append(float(loss))
    r = run_link_sign_prediction.train(args, inputs)
    np.testing.assert_allclose(r["losses"], jlosses, **TOL)
    assert 0.0 <= r["acc"] <= 1.0 and len(r["metrics"]) == 5


@pytest.mark.parametrize("argv", [
    ["--method", "msgnn"], ["--method", "sgcn"], ["--method", "sssnet"],
    ["--method", "msgnn", "--num_classes", "5", "--direction_only"],
    ["--method", "snea", "--dataset", "bitcoin_alpha"]])
def test_run_link_sign_direction_tasks_prints_the_jax_lines(argv, capsys):
    argv = ["--dataset", "synthetic", "--num_nodes", "100", "--epochs", "3",
            "--runs", "2"] + argv
    out = run_link_sign_direction_tasks.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    jx_lsdt.main(argv)
    want = capsys.readouterr().out
    assert template(got) == template(want)
    assert len(out["runs"]) == 2
    assert all(0.0 <= a <= 1.0 for a in out["accs"])
