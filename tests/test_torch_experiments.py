"""Port experiments vs the JAX package's: the host inputs each builds
(data, masks or splits, features, Laplacian arrays) are bit-equal; five
Adam steps from carried-over weights give the same losses and log-probs;
``main`` prints the JAX experiment's lines, on synthetic graphs and on
real-dataset files written in each dataset's schema; the CLI
dispatches."""
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from sklearn.metrics import adjusted_rand_score as sk_ari

import pytorch_geometric_signed_directed_tpu.experiments as jx_experiments
from pytorch_geometric_signed_directed_tpu.data import load_real as jx_load
from pytorch_geometric_signed_directed_tpu.data import (
    DSBM as jx_DSBM, DirectedData as JxDirectedData, SDSBM as jx_SDSBM,
    SSBM as jx_SSBM, SignedData as JxSignedData)
from pytorch_geometric_signed_directed_tpu import graph as jx_graph
from pytorch_geometric_signed_directed_tpu.graph import (
    in_out_degree as jx_in_out_degree)
from pytorch_geometric_signed_directed_tpu.nn import (
    DGCN_link_prediction as JxDGCNLink,
    DIGRAC_node_clustering as JxDIGRAC, DiGCL as JxDiGCL,
    DiGCN_Inception_Block_link_prediction as JxInceptionLink,
    DiGCN_link_prediction as JxDiGCNLink,
    MSGNN_link_prediction as JxMSGNNLink,
    MSGNN_node_classification as JxMSGNNNode,
    MagNet_link_prediction as JxMagNetLink,
    MagNet_node_classification as JxMagNetNode,
    SSSNET_node_clustering as JxSSSNET)
from pytorch_geometric_signed_directed_tpu.experiments.digcl_node import (
    curriculum_alpha as jx_curriculum_alpha)
from pytorch_geometric_signed_directed_tpu.spectral import (
    appr_directed_adj as jx_appr_directed_adj,
    cal_fast_appr as jx_cal_fast_appr,
    magnet_propagators as jx_magnet_propagators,
    second_directed_adj as jx_second_directed_adj)
from pytorch_geometric_signed_directed_tpu.train import Trainer as JxTrainer
from pytorch_geometric_signed_directed_tpu.utils import (
    Prob_Balanced_Normalized_Loss as JxCut,
    Prob_Imbalance_Loss as JxLoss, Unhappy_Ratio as JxUnhappy,
    extract_network as jx_extract_network,
    link_class_split as jx_link_class_split,
    meta_graph_generation as jx_meta_graph_generation)
from pytorch_geometric_signed_directed_tpu.utils.general.triplet_loss import (
    sample_triplets as jx_sample_triplets,
    triplet_loss_inner_product as jx_triplet_loss)

import pytorch_geometric_signed_directed_tpu_torch.__main__ as cli
from pytorch_geometric_signed_directed_tpu_torch.convert import (
    state_dict_from_jax)
from pytorch_geometric_signed_directed_tpu_torch.data import schema_files
from pytorch_geometric_signed_directed_tpu_torch.experiments import (
    EXPERIMENTS, _directed_link, dgcn_link, digcl_node,
    digcn_inception_link, digcn_link, digrac, magnet_link, magnet_node,
    msgnn_link, msgnn_node, run, sssnet)
from pytorch_geometric_signed_directed_tpu_torch.train import Trainer

from test_torch_worker_memory import release_memory  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-4)
N = 80


def assert_same(a, b, path="out"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype, (path, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=path)


def assert_same_laplacian(arrays, edge_index, w, n, **kw):
    """The port's (row, col, vre, vim) equal the JAX segment-tier dual's."""
    D = jx_magnet_propagators(edge_index, w, num_nodes=n, mode="segment",
                              **kw).dual
    nnz = len(arrays[0])
    assert nnz > n
    assert_same(arrays[0], np.asarray(D.row)[:nnz].astype(np.int64))
    assert_same(arrays[1], np.asarray(D.col)[:nnz].astype(np.int64))
    assert_same(arrays[2].astype(np.float32), np.asarray(D.val_a)[:nnz])
    assert_same(arrays[3].astype(np.float32), np.asarray(D.val_b)[:nnz])
    assert np.all(np.asarray(D.row)[nnz:] == n)


def jx_steps(loss_fn, params, lr, weight_decay=0.0, steps=5):
    tr = JxTrainer(loss_fn, lr=lr, weight_decay=weight_decay)
    st = tr.init(params)
    return [tr.step(st) for _ in range(steps)], st.params


def load(model, params):
    model.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    return model


SYN = ["--dataset", "synthetic", "--num_nodes", str(N), "--device", "cpu"]


# --- magnet_node -----------------------------------------------------------

def jx_magnet_node_inputs(seed=0, q=0.2):
    F = jx_meta_graph_generation("cyclic", 5, 0.05, False)
    A, y = jx_DSBM(N, 5, 0.3, F, rng=np.random.default_rng(seed))
    data = JxDirectedData(A=A, y=y)
    data.node_split(train_size_per_class=0.6, val_size_per_class=0.2,
                    data_split=2)
    w = np.ones_like(np.asarray(data.edge_weight, np.float32))
    x = jx_in_out_degree(data.edge_index, N, edge_weight=w)
    x = np.asarray(x / max(x.max(), 1.0))
    lap = jx_magnet_propagators(data.edge_index, w, q=q, num_nodes=N)
    return data, w, x, lap


def test_magnet_node_inputs_bit_equal():
    args = magnet_node.parser().parse_args(SYN)
    got = magnet_node.build_inputs(args, "cpu")
    data, w, x, lap = jx_magnet_node_inputs()
    for name in ("edge_index", "edge_weight", "y", "train_mask", "val_mask",
                 "test_mask", "seed_mask"):
        assert_same(getattr(got.data, name), getattr(data, name), name)
    assert_same(got.x.numpy(), x)
    assert_same_laplacian(got.arrays, data.edge_index, w, N, q=0.2)
    assert got.lap.re.mode == "dense"
    assert_same(got.lap.re.dense.numpy(), np.asarray(lap[0].dense))
    assert_same(got.lap.im.dense.numpy(), np.asarray(lap[1].dense))
    assert set(got.seconds) == {"graph", "features", "laplacian", "layout"}


def test_magnet_node_five_steps_match_jax():
    args = magnet_node.parser().parse_args(
        SYN + ["--epochs", "5", "--dropout", "0"])
    inputs = magnet_node.build_inputs(args, "cpu")
    data, _, x, lap = jx_magnet_node_inputs()
    y = jnp.asarray(data.y)
    mask = jnp.asarray(data.train_mask[:, 1].astype(np.float32))
    jmodel = JxMagNetNode(num_features=2, hidden=64, K=2, q=0.2,
                          label_dim=5, activation=True, dropout=0.0)
    params = jmodel.init(jax.random.PRNGKey(1), x, x, lap)

    def jloss(p):
        logp = jmodel.apply(p, x, x, lap)
        per_node = -logp[jnp.arange(N), y] * mask
        return per_node.sum() / jnp.maximum(mask.sum(), 1.0)

    jlosses, jparams = jx_steps(jloss, params, 5e-3, 5e-4)
    model = load(magnet_node.make_model(args, inputs, 1), params)
    r = magnet_node.train_split(args, inputs, 1, model=model)
    np.testing.assert_allclose(r["losses"], jlosses, **TOL)
    assert r["steps"] == 5 and r["evals"] == 5 and len(r["step_ms"]) == 5
    with torch.no_grad():
        logp = model(inputs.x, inputs.x, inputs.lap)
    np.testing.assert_allclose(logp.numpy(),
                               np.asarray(jmodel.apply(jparams, x, x, lap)),
                               **TOL)


# --- magnet_link -----------------------------------------------------------

def jx_magnet_link(seed=0):
    F = jx_meta_graph_generation("path", 3, 0.05, False)
    A, y = jx_DSBM(N, 3, 0.3, F, rng=np.random.default_rng(seed))
    data = JxDirectedData(A=A, y=y)
    datasets = jx_link_class_split(data, splits=2, task="direction",
                                   seed=seed)
    g = datasets[0]["graph"]
    w = np.ones_like(np.asarray(datasets[0]["weights"], np.float32))
    x = jx_in_out_degree(g, N, edge_weight=w)
    x = np.asarray(x / max(x.max(), 1.0))
    lap = jx_magnet_propagators(g, w, q=0.25, num_nodes=N)
    return data, datasets, g, w, x, lap


def test_magnet_link_inputs_bit_equal():
    args = magnet_link.parser().parse_args(SYN)
    got = magnet_link.build_inputs(args, "cpu")
    s = magnet_link.split_inputs(args, got, 0)
    data, datasets, g, w, x, _ = jx_magnet_link()
    assert_same(got.data.edge_index, data.edge_index)
    assert_same(got.datasets, datasets)
    assert_same(s.x.numpy(), x)
    assert_same_laplacian(s.arrays, g, w, N, q=0.25)
    assert_same(s.tr_e.numpy(), datasets[0]["train"]["edges"])
    assert_same(s.te_y, datasets[0]["test"]["label"])
    assert set(got.seconds) == {"graph", "link_split"}
    assert set(s.seconds) == {"features", "laplacian", "layout"}


def test_magnet_link_five_steps_match_jax():
    args = magnet_link.parser().parse_args(SYN + ["--epochs", "5"])
    inputs = magnet_link.build_inputs(args, "cpu")
    s = magnet_link.split_inputs(args, inputs, 0)
    _, datasets, _, _, x, lap = jx_magnet_link()
    tr_e = jnp.asarray(datasets[0]["train"]["edges"])
    tr_y = jnp.asarray(datasets[0]["train"]["label"])
    te_e = jnp.asarray(datasets[0]["test"]["edges"])
    jmodel = JxMagNetLink(num_features=2, hidden=16, K=2, q=0.25,
                          label_dim=2, activation=True)
    params = jmodel.init(jax.random.PRNGKey(0), x, x, lap, tr_e)

    def jloss(p):
        logp = jmodel.apply(p, x, x, lap, tr_e)
        return -jnp.mean(logp[jnp.arange(tr_e.shape[0]), tr_y])

    jlosses, jparams = jx_steps(jloss, params, 5e-3)
    model = load(magnet_link.make_model(args, inputs), params)
    r = magnet_link.train_split(args, inputs, s, model=model)
    np.testing.assert_allclose(r["losses"], jlosses, **TOL)
    with torch.no_grad():
        logp = model(s.x, s.x, s.lap, s.te_e)
    np.testing.assert_allclose(
        logp.numpy(), np.asarray(jmodel.apply(jparams, x, x, lap, te_e)),
        **TOL)


# --- msgnn_node ------------------------------------------------------------

def jx_msgnn_node(seed=0):
    F = jx_meta_graph_generation("cyclic", 3, 0.05, False)
    F[0, 1] = -abs(F[0, 1])
    F[1, 0] = -abs(F[1, 0])
    A, y = jx_SDSBM(N, 3, 0.1, F, eta=0.1, rng=np.random.default_rng(seed))
    data = JxSignedData(A=A, y=y)
    data.node_split(train_size_per_class=0.6, val_size_per_class=0.2,
                    data_split=2)
    x = jx_in_out_degree(data.edge_index, N, signed=True,
                         edge_weight=data.edge_weight)
    x = np.asarray(x / max(np.abs(x).max(), 1.0))
    lap = jx_magnet_propagators(data.edge_index, data.edge_weight, q=0.25,
                                num_nodes=N, signed=True)
    return data, x, lap


def test_msgnn_node_inputs_bit_equal():
    args = msgnn_node.parser().parse_args(SYN)
    got = msgnn_node.build_inputs(args, "cpu")
    data, x, _ = jx_msgnn_node()
    for name in ("edge_index", "edge_weight", "y", "train_mask", "val_mask",
                 "test_mask"):
        assert_same(getattr(got.data, name), getattr(data, name), name)
    assert got.data.is_signed
    assert_same(got.x.numpy(), x)
    assert_same_laplacian(got.arrays, data.edge_index, data.edge_weight, N,
                          q=0.25, signed=True)


def test_msgnn_node_five_steps_match_jax():
    args = msgnn_node.parser().parse_args(SYN + ["--epochs", "5"])
    inputs = msgnn_node.build_inputs(args, "cpu")
    data, x, lap = jx_msgnn_node()
    y = jnp.asarray(data.y)
    mask = jnp.asarray(data.train_mask[:, 0].astype(np.float32))
    jmodel = JxMSGNNNode(num_features=4, hidden=16, K=1, q=0.25,
                         label_dim=3)
    params = jmodel.init(jax.random.PRNGKey(0), x, x, lap)

    def jloss(p):
        _, logp, _, _ = jmodel.apply(p, x, x, lap)
        per_node = -logp[jnp.arange(N), y] * mask
        return per_node.sum() / jnp.maximum(mask.sum(), 1.0)

    jlosses, jparams = jx_steps(jloss, params, 1e-2, 5e-4)
    model = load(msgnn_node.make_model(args, inputs, 0), params)
    r = msgnn_node.train_split(args, inputs, 0, model=model)
    np.testing.assert_allclose(r["losses"], jlosses, **TOL)
    with torch.no_grad():
        logp = model(inputs.x, inputs.x, inputs.lap)[1]
    np.testing.assert_allclose(
        logp.numpy(), np.asarray(jmodel.apply(jparams, x, x, lap)[1]), **TOL)


# --- msgnn_link ------------------------------------------------------------

def jx_msgnn_link(task="four_class_signed_digraph", features="sd4",
                  seed=0):
    F = jx_meta_graph_generation("cyclic", 3, 0.05, False)
    F[0, 1] = -abs(F[0, 1])
    A, y = jx_SDSBM(N, 3, 0.1, F, eta=0.1, rng=np.random.default_rng(seed))
    data = JxSignedData(A=A, y=y)
    datasets = jx_link_class_split(data, splits=1, task=task, seed=seed,
                                   maintain_connect=False)
    g, w = datasets[0]["graph"], datasets[0]["weights"]
    if features == "sd4":
        d = JxSignedData(edge_index=np.asarray(g), edge_weight=np.asarray(w))
        d.separate_positive_negative()
        x = np.concatenate([np.asarray(jx_in_out_degree(d.edge_index_p, N)),
                            np.asarray(jx_in_out_degree(d.edge_index_n, N))],
                           axis=1)
    elif features == "uw2":
        x = jx_in_out_degree(g, N)
    else:
        x = jx_in_out_degree(g, N, signed=True, edge_weight=w)
    x = np.asarray(x, np.float32)
    x = np.asarray(x / max(np.abs(x).max(), 1.0))
    lap = jx_magnet_propagators(g, w, q=0.0, num_nodes=N, signed=True)
    return datasets, g, w, x, lap


@pytest.mark.parametrize("task,features", [
    ("four_class_signed_digraph", "sd4"), ("five_class_signed_digraph", "w4"),
    ("sign", "uw2")])
def test_msgnn_link_inputs_bit_equal(task, features):
    args = msgnn_link.parser().parse_args(
        SYN + ["--task", task, "--features", features])
    got = msgnn_link.build_inputs(args, "cpu")
    datasets, g, w, x, _ = jx_msgnn_link(task, features)
    assert_same(got.datasets, datasets)
    assert_same(got.x.numpy(), x)
    assert_same_laplacian(got.arrays, g, w, N, q=0.0, signed=True)
    assert got.label_dim == {"four_class_signed_digraph": 4,
                             "five_class_signed_digraph": 5,
                             "sign": 2}[task]


def test_msgnn_link_five_steps_match_jax():
    args = msgnn_link.parser().parse_args(SYN + ["--epochs", "5"])
    inputs = msgnn_link.build_inputs(args, "cpu")
    datasets, _, _, x, lap = jx_msgnn_link()
    tr_e = jnp.asarray(datasets[0]["train"]["edges"])
    tr_y = jnp.asarray(datasets[0]["train"]["label"])
    te_e = jnp.asarray(datasets[0]["test"]["edges"])
    jmodel = JxMSGNNLink(num_features=4, hidden=64, K=1, q=0.0,
                         label_dim=4)
    params = jmodel.init(jax.random.PRNGKey(0), x, x, lap, tr_e)

    def jloss(p):
        logp, _ = jmodel.apply(p, x, x, lap, tr_e)
        return -jnp.mean(logp[jnp.arange(tr_e.shape[0]), tr_y])

    jlosses, jparams = jx_steps(jloss, params, 1e-2)
    model = load(msgnn_link.make_model(args, inputs), params)
    r = msgnn_link.train_split(args, inputs, model=model)
    np.testing.assert_allclose(r["losses"], jlosses, **TOL)
    with torch.no_grad():
        logp = model(inputs.x, inputs.x, inputs.lap, inputs.te_e)[0]
    np.testing.assert_allclose(
        logp.numpy(), np.asarray(jmodel.apply(jparams, x, x, lap, te_e)[0]),
        **TOL)


# --- digrac ----------------------------------------------------------------

DIGRAC_N = 150
DIGRAC = ["--N", str(DIGRAC_N), "--device", "cpu"]


def jx_digrac_inputs(seed=0, k=3):
    F = jx_meta_graph_generation("cyclic", k, 0.05, False)
    A, labels = jx_DSBM(DIGRAC_N, k, 0.1, F, rng=np.random.default_rng(seed))
    data = JxDirectedData(A=A, y=labels)
    x = jx_in_out_degree(data.edge_index, DIGRAC_N,
                         edge_weight=data.edge_weight)
    x = np.asarray(x / max(x.max(), 1.0))
    ei, w = data.edge_index, data.edge_weight
    ops = (jx_graph.rw_norm_propagator(ei, w, DIGRAC_N),
           jx_graph.rw_norm_propagator(ei[[1, 0]], w, DIGRAC_N),
           (jx_graph.norm_propagator(ei[[1, 0]], w, DIGRAC_N),
            jx_graph.norm_propagator(ei, w, DIGRAC_N)))
    return data, F, x, ops


def test_digrac_inputs_bit_equal():
    args = digrac.parser().parse_args(DIGRAC + ["--features", "degree"])
    got = digrac.build_inputs(args, "cpu")
    data, F, x, (P_s, P_t, (P_A, P_AT)) = jx_digrac_inputs()
    for name in ("edge_index", "edge_weight", "y"):
        assert_same(getattr(got.data, name), getattr(data, name), name)
    assert_same(got.F, F)
    assert_same(got.x.numpy(), x)
    for mine, theirs in ((got.P_s, P_s), (got.P_t, P_t), (got.A[0], P_A),
                         (got.A[1], P_AT)):
        assert mine.mode == theirs.mode == "dense"
        assert_same(mine.dense.numpy(), np.asarray(theirs.dense))
    assert set(got.seconds) == {"graph", "features", "operators"}


def test_digrac_five_steps_match_jax():
    args = digrac.parser().parse_args(
        DIGRAC + ["--features", "degree", "--epochs", "5"])
    inputs = digrac.build_inputs(args, "cpu")
    _, F, x, (P_s, P_t, A) = jx_digrac_inputs()
    jmodel = JxDIGRAC(num_features=2, hidden=32, nclass=3, hop=2,
                      dropout=0.0)
    params = jmodel.init(jax.random.PRNGKey(0), P_s, P_t, x)
    imb = JxLoss(F)

    def jloss(p):
        return imb(jmodel.apply(p, P_s, P_t, x)[3], A, 3, "vol_sum", "sort")

    jlosses, jparams = jx_steps(jloss, params, 1e-2)
    model = load(digrac.make_model(args, inputs), params)
    r = digrac.train(args, inputs, model=model)
    np.testing.assert_allclose(r["losses"], jlosses, **TOL)
    np.testing.assert_allclose(r["loss"], float(jloss(jparams)), **TOL)
    pred = np.asarray(jmodel.apply(jparams, P_s, P_t, x)[2])
    np.testing.assert_array_equal(r["pred"], pred)
    assert r["ari"] == sk_ari(inputs.labels, pred)


def test_digrac_hermitian_features_run_on_the_cpu():
    args = digrac.parser().parse_args(DIGRAC + ["--epochs", "3"])
    inputs = digrac.build_inputs(args, "cpu")
    assert inputs.x.shape == (DIGRAC_N, 6) and inputs.x.dtype == torch.float32
    # standardized columns
    np.testing.assert_allclose(inputs.x.mean(0).numpy(), 0, atol=1e-5)
    r = digrac.train(args, inputs)
    assert len(r["losses"]) == 3 and np.isfinite(r["losses"]).all()
    assert -1.0 <= r["ari"] <= 1.0


# --- the DGCN and DiGCN link experiments -----------------------------------

def jx_link_operators(name, g, w, n):
    """(JAX Propagators, host arrays) of one link experiment's split."""
    if name == "dgcn_link":
        idx, e_in, w_in, e_out, w_out = jx_graph.directed_features_in_out(
            g, n, w)
        arrays = [(idx, None), (e_in, w_in), (e_out, w_out)]
        build = jx_graph.gcn_norm_propagator
    else:
        arrays = [jx_appr_directed_adj(0.1, g, n, w)]
        if name == "digcn_inception_link":
            arrays.append(jx_second_directed_adj(g, n, w))
        build = jx_graph.norm_propagator
    return [build(e, v, n) for e, v in arrays], arrays


LINK = {"dgcn_link": (dgcn_link, JxDGCNLink),
        "digcn_link": (digcn_link, JxDiGCNLink),
        "digcn_inception_link": (digcn_inception_link, JxInceptionLink)}


def jx_link_split(name, seed=0):
    F = jx_meta_graph_generation("path", 3, 0.05, False)
    A, y = jx_DSBM(N, 3, 0.3, F, rng=np.random.default_rng(seed))
    datasets = jx_link_class_split(JxDirectedData(A=A, y=y), splits=2,
                                   task="direction", seed=seed)
    g, w = datasets[0]["graph"], datasets[0]["weights"]
    x = jx_in_out_degree(g, N, edge_weight=w)
    x = np.asarray(x / max(x.max(), 1.0))
    ops, arrays = jx_link_operators(name, g, w, N)
    return datasets, x, ops, arrays


@pytest.mark.parametrize("name", sorted(LINK))
def test_link_experiment_inputs_bit_equal(name):
    mod = LINK[name][0]
    args = mod.parser().parse_args(SYN)
    got = _directed_link.build_inputs(args, "cpu")
    s = _directed_link.split_inputs(args, got, 0, mod)
    datasets, x, ops, arrays = jx_link_split(name)
    assert_same(got.datasets, datasets)
    assert_same(s.x.numpy(), x)
    assert len(s.arrays) == len(arrays) == len(s.ops)
    for (e, v), (je, jv) in zip(s.arrays, arrays):
        assert_same(e, je)
        if v is None:
            assert jv is None
        else:
            assert_same(v, jv)
    for P, J in zip(s.ops, ops):
        assert P.mode == J.mode == "dense"
        assert_same(P.dense.numpy(), np.asarray(J.dense))
    assert_same(s.tr_e.numpy(), datasets[0]["train"]["edges"])
    assert set(got.seconds) == {"graph", "link_split"}
    assert set(s.seconds) == {"features", "operators", "layout"}


@pytest.mark.parametrize("name", sorted(LINK))
def test_link_experiment_five_steps_match_jax(name):
    mod, jcls = LINK[name]
    args = mod.parser().parse_args(SYN + ["--epochs", "5"])
    inputs = _directed_link.build_inputs(args, "cpu")
    s = _directed_link.split_inputs(args, inputs, 0, mod)
    datasets, x, ops, _ = jx_link_split(name)
    tr_e = jnp.asarray(datasets[0]["train"]["edges"])
    tr_y = jnp.asarray(datasets[0]["train"]["label"])
    te_e = jnp.asarray(datasets[0]["test"]["edges"])
    jmodel = jcls(num_features=2, hidden=16, label_dim=2)
    params = jmodel.init(jax.random.PRNGKey(0), x, *ops, tr_e)

    def jloss(p):
        logp = jmodel.apply(p, x, *ops, tr_e)
        return -jnp.mean(logp[jnp.arange(tr_e.shape[0]), tr_y])

    jlosses, jparams = jx_steps(jloss, params, 1e-2, 5e-4)
    model = load(mod.make_model(args, inputs), params)
    r = _directed_link.train_split(args, s, model)
    np.testing.assert_allclose(r["losses"], jlosses, **TOL)
    with torch.no_grad():
        logp = model(s.x, *s.ops, s.te_e)
    np.testing.assert_allclose(
        logp.numpy(), np.asarray(jmodel.apply(jparams, x, *ops, te_e)),
        **TOL)


# --- sssnet ----------------------------------------------------------------

SSSNET_N = 300
SSSNET = ["--N", str(SSSNET_N), "--device", "cpu"]


@pytest.fixture
def fixed_eigs(monkeypatch):
    """``eigs`` with a fixed start vector (the features' only randomness),
    in both packages."""
    import scipy.sparse.linalg as spla

    eigs = spla.eigs

    def fixed(M, k=6, **kw):
        v0 = np.random.default_rng(0).standard_normal(M.shape[0])
        return eigs(M, k=k, v0=v0, **kw)

    monkeypatch.setattr(spla, "eigs", fixed)


def jx_sssnet_inputs(seed=0, k=3):
    (A_p, A_n), labels = jx_SSBM(SSSNET_N, k, 0.1, 0.1, size_ratio=1.5,
                                 rng=np.random.default_rng(seed))
    A, labels = jx_extract_network((A_p - A_n).tocsr(), labels)
    data = JxSignedData(A=A, y=labels)
    data.set_spectral_adjacency_reg_features(k=k)
    data.node_split(train_size_per_class=0.8, val_size_per_class=0.1,
                    seed_size_per_class=0.1, data_split=2)
    data.separate_positive_negative()
    n = data.num_nodes
    P_p = jx_graph.rw_norm_propagator(data.edge_index_p, data.edge_weight_p,
                                      n, 0.5)
    P_n = jx_graph.rw_norm_propagator(data.edge_index_n, data.edge_weight_n,
                                      n, 0.0)
    return data, P_p, P_n


def test_sssnet_inputs_match_jax(fixed_eigs):
    args = sssnet.parser().parse_args(SSSNET)
    got = sssnet.build_inputs(args, "cpu")
    data, P_p, P_n = jx_sssnet_inputs()
    for name in ("edge_index", "edge_weight", "y", "train_mask", "val_mask",
                 "test_mask", "seed_mask", "edge_index_p", "edge_weight_p",
                 "edge_index_n", "edge_weight_n"):
        assert_same(getattr(got.data, name), getattr(data, name), name)
    assert_same(got.x.numpy(), np.asarray(data.x, np.float32))
    for mine, theirs in ((got.P_p, P_p), (got.P_n, P_n)):
        assert mine.mode == theirs.mode == "dense"
        assert_same(mine.dense.numpy(), np.asarray(theirs.dense))
    cut = JxCut(data.A_p.tocsr(), data.A_n.tocsr())
    assert_same(got.cut.mat.dense.numpy(), np.asarray(cut.mat.dense))
    assert_same(got.cut.D_bar.dense.numpy(), np.asarray(cut.D_bar.dense))
    assert got.unhappy.num_edges == JxUnhappy(
        data.A_p.tocsr(), data.A_n.tocsr()).num_edges
    assert set(got.seconds) == {"graph", "features", "split", "operators"}
    # the triplets of each step, drawn up front in the JAX order
    trip, nsc, ncl = sssnet.triplet_batches(args, got, 4)
    rng = np.random.default_rng(0)
    for step in range(4):
        want = jx_sample_triplets(np.asarray(data.y), data.num_nodes, 200,
                                  rng)
        assert (nsc, ncl) == want[3:]
        assert_same(trip[step].numpy(), np.stack(want[:3]))


@pytest.mark.parametrize("split", [0, 1])
def test_sssnet_five_steps_match_jax(fixed_eigs, split):
    args = sssnet.parser().parse_args(SSSNET + ["--epochs", "5"])
    inputs = sssnet.build_inputs(args, "cpu")
    data, P_p, P_n = jx_sssnet_inputs()
    x = jnp.asarray(np.asarray(data.x, np.float32))
    y = jnp.asarray(data.y)
    train_idx = jnp.asarray(np.nonzero(data.train_mask[:, split])[0])
    cut = JxCut(data.A_p.tocsr(), data.A_n.tocsr())
    jmodel = JxSSSNET(nfeat=3, hidden=16, nclass=3, hop=2)
    params = jmodel.init(jax.random.PRNGKey(0), P_p, P_n, x)

    def jloss(p, *triplets):
        z, logp, _, prob = jmodel.apply(p, P_p, P_n, x)
        nll = -jnp.mean(logp[train_idx, y[train_idx]])
        return (50.0 * (nll + 0.1 * jx_triplet_loss(z, *triplets))
                + cut(prob))

    tr = JxTrainer(jloss, lr=1e-2)
    st = tr.init(params)
    rng = np.random.default_rng(0)
    jlosses = [tr.step(st, *jx_sample_triplets(np.asarray(data.y),
                                               data.num_nodes, 200, rng))
               for _ in range(5)]
    model = load(sssnet.make_model(args, inputs), params)
    r = sssnet.train_split(args, inputs, split, model=model)
    np.testing.assert_allclose(r["losses"], jlosses, **TOL)
    _, _, pred, prob = jmodel.apply(st.params, P_p, P_n, x)
    np.testing.assert_array_equal(r["pred"], np.asarray(pred))
    test = np.nonzero(data.test_mask[:, split])[0]
    assert r["ari"] == sk_ari(np.asarray(data.y)[test],
                              np.asarray(pred)[test])
    unhappy = JxUnhappy(data.A_p.tocsr(), data.A_n.tocsr())(prob)
    np.testing.assert_allclose(r["unhappy"], float(unhappy), **TOL)
    assert set(r["host_seconds"]) == {"samplers"}


# --- digcl_node (on the schema files of ``schema_dir``) --------------------

def jx_digcl_view(alpha, edge_index, n, w):
    ei, v = jx_cal_fast_appr(alpha, edge_index, n, w)
    return jx_graph.gcn_norm_propagator(ei, v, n, mode="dense")


def test_digcl_node_inputs_bit_equal(in_schema_dir):
    args = digcl_node.parser().parse_args(["--epochs", "30", "--device",
                                           "cpu"])
    got = digcl_node.build_inputs(args, "cpu")
    data = jx_load.load_directed_real_data("cora_ml", name="cora_ml")
    for name in ("edge_index", "edge_weight", "y", "train_mask", "val_mask",
                 "test_mask"):
        assert_same(getattr(got.data, name), getattr(data, name), name)
    assert_same(got.x.numpy(), np.asarray(data.x, np.float32))
    n = data.num_nodes
    P1 = jx_digcl_view(0.1, data.edge_index, n, data.edge_weight)
    assert got.P1.mode == "dense"
    assert_same(got.P1.dense.numpy(), np.asarray(P1.dense))
    # the log curriculum's views: one operator per distinct alpha, the
    # first at alpha 1.7
    alphas = [digcl_node.curriculum_alpha("log", e, 30) for e in range(30)]
    assert alphas == [float(jx_curriculum_alpha("log", e, 30))
                      for e in range(30)]
    assert alphas[0] == pytest.approx(1.7)
    for a in (alphas[0], alphas[11], alphas[-1]):
        mine = digcl_node.view(got, got.data.edge_index,
                               got.data.edge_weight, a, got.views)
        assert_same(mine.dense.numpy(),
                    np.asarray(jx_digcl_view(a, data.edge_index, n,
                                       data.edge_weight).dense))
    assert len(got.views) == 3
    assert set(got.seconds) == {"load", "features", "views"}


def test_digcl_node_five_steps_match_jax(in_schema_dir):
    """Five steps from the JAX weights on the same dropped-feature inputs
    (masks from numpy) and the curriculum's views, optax's coupled L2
    beside the port's Trainer; then the embedding the probe reads."""
    args = digcl_node.parser().parse_args(["--epochs", "5"])
    inputs = digcl_node.build_inputs(args, "cpu")
    data = jx_load.load_directed_real_data("cora_ml", name="cora_ml")
    n, x = data.num_nodes, np.asarray(data.x, np.float32)
    P1 = jx_digcl_view(0.1, data.edge_index, n, data.edge_weight)
    alphas = [digcl_node.curriculum_alpha("log", e, 5) for e in range(5)]
    jviews = [jx_digcl_view(a, data.edge_index, n, data.edge_weight)
              for a in alphas]
    views = [digcl_node.view(inputs, data.edge_index, data.edge_weight, a,
                             inputs.views) for a in alphas]
    rng = np.random.default_rng(0)
    xs = [(np.where(rng.random(x.shape[1]) < 0.3, 0.0, x).astype(np.float32),
           np.where(rng.random(x.shape[1]) < 0.4, 0.0, x).astype(np.float32))
          for _ in range(5)]
    jm = JxDiGCL(in_channels=x.shape[1], activation="relu", num_hidden=64,
                 num_proj_hidden=32, tau=0.4, num_layers=2)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), P1,
                     method=JxDiGCL.warmup)
    model = load(digcl_node.make_model(args, x.shape[1], "cpu", 0, "relu"),
                 params)
    tx = optax.chain(optax.add_decayed_weights(5e-4), optax.adam(1e-3))
    opt = tx.init(params)
    jlosses = []
    for (x1, x2), P2 in zip(xs, jviews):
        def jf(p):
            return jm.apply(p, jm.apply(p, x1, P1), jm.apply(p, x2, P2),
                            method=JxDiGCL.loss)

        loss, grads = jax.value_and_grad(jf)(params)
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        jlosses.append(float(loss))
    trainer = Trainer(digcl_node.loss_function(inputs.P1), lr=1e-3,
                      weight_decay=5e-4, device="cpu")
    state = trainer.init(model)
    losses = [trainer.step(state, torch.from_numpy(x1), torch.from_numpy(x2),
                           P2) for (x1, x2), P2 in zip(xs, views)]
    np.testing.assert_allclose(losses, jlosses, **TOL)
    with torch.no_grad():
        z = model(inputs.x, inputs.P1).numpy()
    np.testing.assert_allclose(z, np.asarray(jm.apply(params, x, P1)),
                               **TOL)


# --- main and the CLI ------------------------------------------------------

def template(text):
    """Printed lines with every number replaced by '#'."""
    return [re.sub(r"\d+(\.\d+)?", "#", line) for line in
            text.strip().splitlines()]


SYNTHETIC = ["--dataset", "synthetic"]
MAIN_ARGS = {
    "magnet_node": SYNTHETIC + ["--num_nodes", "80", "--epochs", "5"],
    "magnet_link": SYNTHETIC + ["--num_nodes", "80", "--epochs", "5",
                                "--splits", "1"],
    "msgnn_node": SYNTHETIC + ["--num_nodes", "150", "--epochs", "3"],
    "msgnn_link": SYNTHETIC + ["--num_nodes", "100", "--epochs", "5"],
    "digrac": ["--N", "120", "--epochs", "5", "--features", "degree"],
    "sssnet": ["--N", "200", "--epochs", "3"],
    "dgcn_link": SYNTHETIC + ["--num_nodes", "80", "--epochs", "5"],
    "digcn_link": SYNTHETIC + ["--num_nodes", "80", "--epochs", "5",
                               "--splits", "1"],
    "digcn_inception_link": SYNTHETIC + ["--num_nodes", "80", "--epochs",
                                         "5", "--splits", "1"],
    "link_sign_direction_tasks": SYNTHETIC + ["--num_nodes", "100",
                                              "--epochs", "5"],
    # the experiments that read only real data, on the schema files of
    # ``schema_dir``
    "dgcn_node": ["--dataset", "telegram", "--epochs", "3"],
    "digcn_node": ["--dataset", "cora_ml", "--epochs", "3"],
    "digcn_inception_node": ["--dataset", "telegram", "--epochs", "3"],
    "digcl_node": ["--epochs", "4", "--splits", "2"],
    "digcl_link": ["--dataset", "telegram", "--epochs", "4", "--splits",
                   "1"],
    "link_sign_prediction": ["--epochs", "3"],
}
# host stages each experiment reports; printed lines beside its accuracies
STAGES = {"digrac": {"graph", "features", "operators"},
          "sssnet": {"graph", "features", "split", "operators", "samplers"},
          "dgcn_link": {"graph", "link_split", "operators", "layout"},
          "digcn_link": {"graph", "link_split", "operators", "layout"},
          "digcn_inception_link": {"graph", "link_split", "operators",
                                   "layout"},
          "dgcn_node": {"load", "features", "operators", "layout"},
          "digcn_node": {"load", "features", "operators", "layout"},
          "digcn_inception_node": {"load", "features", "operators", "layout"},
          "digcl_node": {"load", "features", "views", "probe"},
          "digcl_link": {"load", "link_split", "views", "probe"},
          "link_sign_prediction": {"load", "link_split", "operators",
                                   "probe"}}
STAGES["link_sign_direction_tasks"] = STAGES.get("msgnn_link", {
    "graph", "laplacian", "layout"})
SUMMARY_LINES = {"msgnn_link": 0, "digrac": 0, "link_sign_direction_tasks": 0,
                 "link_sign_prediction": 0}


@pytest.fixture(scope="module")
def schema_dir(tmp_path_factory):
    """Small graphs in the schema of each real dataset the experiments
    read, written once for the module."""
    r = str(tmp_path_factory.mktemp("datasets"))
    schema_files.write_citation(r, "cora_ml", num_nodes=700,
                                num_edges=2500, num_classes=3,
                                num_features=40)
    schema_files.write_citation(r, "citeseer", num_nodes=700,
                                num_edges=2000, num_classes=3,
                                num_features=40, seed=1)
    schema_files.write_telegram(r, num_nodes=60, num_edges=600,
                                num_classes=3)
    schema_files.write_signed_csv(r, num_nodes=200, num_pos=900, num_neg=200)
    schema_files.write_sssnet(r, num_nodes=40, num_edges=300, num_classes=3)
    schema_files.write_digrac(r, num_nodes=150, num_edges=900)
    return r


@pytest.fixture
def in_schema_dir(schema_dir, monkeypatch):
    """Run from ``schema_dir`` (the dispatchers' default root "./"), with
    the processed-array cache off and no other search path."""
    monkeypatch.chdir(schema_dir)
    monkeypatch.setenv("PGSD_TPU_NO_CACHE", "1")
    monkeypatch.delenv("PGSD_TPU_DATA", raising=False)
    monkeypatch.setattr(jx_load, "_SEARCH_PATHS", ["", "datasets"])
    return schema_dir


@pytest.mark.parametrize("name", sorted(MAIN_ARGS))
def test_main_prints_the_jax_lines(name, capsys, fixed_eigs, in_schema_dir):
    argv = MAIN_ARGS[name]
    out = run(name, argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    jx_experiments.run(name, argv)
    want = capsys.readouterr().out
    assert template(got) == template(want)
    assert len(out["accs"]) == len(out["seconds"]) == len(template(got)) - (
        SUMMARY_LINES.get(name, 1))
    # accuracies in [0, 1]; the ARIs of digrac and sssnet in [-1, 1]
    assert all(-1.0 <= a <= 1.0 for a in out["accs"])
    assert name in ("digrac", "sssnet") or all(0.0 <= a for a in out["accs"])
    assert STAGES.get(name, {"graph", "laplacian", "layout"}) <= set(
        out["host_seconds"])


@pytest.mark.parametrize("name", sorted(MAIN_ARGS))
def test_without_device_the_experiments_need_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(name, MAIN_ARGS[name])


@pytest.mark.parametrize("name,dataset", [
    ("magnet_node", "telegram"), ("magnet_link", "cora_ml"),
    ("msgnn_node", "bitcoin_alpha"), ("msgnn_link", "bitcoin_alpha"),
    ("digrac", "blog"), ("sssnet", "sampson"), ("dgcn_link", "telegram"),
    ("digcn_link", "cora_ml"), ("digcn_inception_link", "citeseer")])
def test_a_real_dataset_prints_the_jax_lines(name, dataset, capsys,
                                             fixed_eigs, in_schema_dir):
    """Each experiment on a real dataset's schema files prints the JAX
    experiment's lines.  bitcoin_alpha has no node labels: msgnn_node's
    node split fails on it in both packages, with the same error."""
    argv = ["--dataset", dataset, "--epochs", "2"]
    if name in ("magnet_link", "digcn_link", "digcn_inception_link"):
        argv += ["--splits", "1"]
    if name == "msgnn_node":
        with pytest.raises(IndexError):
            run(name, argv + ["--device", "cpu"])
        with pytest.raises(IndexError):
            jx_experiments.run(name, argv)
        return
    out = run(name, argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    jx_experiments.run(name, argv)
    want = capsys.readouterr().out
    assert template(got) == template(want)
    assert out["inputs"].num_edges > 0
    if name == "digrac":
        # no labels: the score line, and the score as the run's value
        assert got.startswith(f"{dataset}: imbalance loss")
        assert out["runs"][0]["ari"] is None


def test_registry_and_cli(capsys):
    # every experiment of the JAX package is ported
    assert set(EXPERIMENTS) == set(jx_experiments.EXPERIMENTS)
    cli.main(["--list"])
    listing = capsys.readouterr().out
    assert all(name in listing for name in EXPERIMENTS)
    with pytest.raises(SystemExit, match="unknown experiment"):
        cli.main(["no_such_experiment"])


def test_both_registries_resolve_every_name_to_the_same_module():
    for name, (module, _) in jx_experiments.EXPERIMENTS.items():
        assert EXPERIMENTS[name][0] == module, name
    assert EXPERIMENTS["link_sign_direction_tasks"][0] == "msgnn_link"


def test_link_sign_direction_tasks_runs_msgnn_link(capsys):
    out = cli.main(["link_sign_direction_tasks", "--dataset", "synthetic",
                    "--num_nodes", "80", "--epochs", "2", "--device",
                    "cpu"])
    assert "four_class_signed_digraph test acc" in capsys.readouterr().out
    assert out["runs"][0]["steps"] == 2


def test_python_m_runs_an_experiment(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_geometric_signed_directed_tpu_torch",
         "msgnn_node", "--dataset", "synthetic", "--num_nodes", "60",
         "--epochs", "2", "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    assert proc.returncode == 0, proc.stderr
    assert "mean test acc" in proc.stdout


def test_cli_dispatches_sssnet(capsys):
    out = cli.main(["sssnet", "--dataset", "ssbm", "--N", "150", "--epochs",
                    "2", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "mean ARI" in printed and len(out["runs"]) == 2
    assert all(len(r["losses"]) == 2 for r in out["runs"])
