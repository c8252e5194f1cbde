"""The port's SDGNN against the benchmark's plain float64 reference
(``port_bench/reference/sdgnn.py``) at a small size on the CPU: the loss,
its gradients and three AdamW steps on the per-motif and the stacked
path; the triangle weights; the signed generator (host and torch draws
equal, its counts at seed 0, other seeds other draws); the torch range
finder of the spectral features against the numpy one; the cell's check
failing on faults planted in the port; and the cell's metric readers."""
import os
import sys
import time

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench import check, cost_scatter, harness, trace  # noqa: E402
from port_bench.drivers.sdgnn import per_motif  # noqa: E402
from port_bench.gen import signed_powerlaw  # noqa: E402
from port_bench.reference import common as ref_common  # noqa: E402
from port_bench.reference import sdgnn as ref  # noqa: E402
from pytorch_geometric_signed_directed_tpu_torch.instrument import (  # noqa
    reset_counts)
from pytorch_geometric_signed_directed_tpu_torch.nn import SDGNN  # noqa
from pytorch_geometric_signed_directed_tpu_torch.nn.signed import (  # noqa
    motif_stack, motifs, sdgnn, snea_conv)
from pytorch_geometric_signed_directed_tpu_torch.spectral import (  # noqa
    features)
from pytorch_geometric_signed_directed_tpu_torch.train import adam  # noqa
from pytorch_geometric_signed_directed_tpu_torch.utils.signed import (  # noqa
    link_sign_loss)
from test_torch_worker_memory import release_memory  # noqa: F401,E402

CELL = "sdgnn.epinions_signed"
TINY = dict(nodes=500, positive=2000, negative=500)
SEED = 2 ** 31 + 21


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Epochs of tiny ops: beside the suite's other parallel workers,
    torch's intra-op threads contend for the cores (the SDGNN span report
    took ~390 s so, 5 s alone); one thread keeps each test at its own
    cost."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_cell(fused=True):
    """The cell at a tiny size: as configured (the motif stack), or with
    one GATConv a motif graph."""
    cell = harness.Cell.find(harness.ROOT, CELL)
    cell.traffic.update(TINY)
    cell.config = dict(cell.config, fused=fused)
    return cell


def tiny_graph(seed=SEED, **kw):
    traffic = dict(tiny_cell().traffic, **kw)
    return signed_powerlaw.generate(traffic, seed)


def port_readings(config, graph, inputs, params, fused, planned=False):
    """The port's SDGNN (float32, K1's plain version on the CPU) from the
    reference's parameters: three AdamW steps' losses, the first
    gradient and the change, as the benchmark's driver reads them; with
    ``planned``, the edge lists as ``PlannedEdges``."""
    n = graph["num_nodes"]
    es = np.vstack([graph["edge_index"], graph["edge_sign"]]).T
    pos, neg, _, graphs, w_pos, w_neg = sdgnn.prepare_sdgnn_inputs(
        n, es, config["in_dim"], init_emb=np.zeros((n, config["in_dim"])),
        fused=fused, device="cpu")
    model = SDGNN(node_num=n, in_dim=config["in_dim"],
                  out_dim=config["out_dim"], layer_num=config["layer_num"],
                  lamb_d=config["lamb_d"], lamb_t=config["lamb_t"],
                  init_emb=np.zeros((n, config["in_dim"])), fused=fused,
                  device="cpu")
    state = dict(params, x=ref.input_embedding(n, config["in_dim"], inputs,
                                               "cpu"))
    if fused:
        state = motif_stack.stack_state_dict(state)
    model.load_state_dict(state, strict=True)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt = adam(config["lr"], config["weight_decay"], decoupled=True)(
        model.parameters())
    edges = ((link_sign_loss.plan_edges(e, n, "cpu") for e in (pos, neg))
             if planned else (torch.as_tensor(pos), torch.as_tensor(neg)))
    args = (graphs, *edges, torch.as_tensor(w_pos), torch.as_tensor(w_neg))
    losses, grad1 = [], None
    for _ in range(3):
        opt.zero_grad(set_to_none=True)
        loss = model.loss(*args)
        loss.backward()
        if grad1 is None:
            grad1 = {k: p.grad.clone() for k, p in model.named_parameters()}
        losses.append(float(loss))
        opt.step()
    change = {k: p.detach() - p0[k] for k, p in model.named_parameters()}
    return harness.host_readings(dict(losses=losses, grad1=per_motif(grad1),
                                      change=per_motif(change)))


@pytest.mark.parametrize("planned", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_port_against_the_reference(fused, planned):
    cell = tiny_cell()
    graph = tiny_graph()
    inputs = harness.task_inputs(cell.config, graph, SEED)
    spec = ref.param_spec(cell.config)
    params = ref_common.draw_params(spec, SEED, "cpu")
    got = port_readings(cell.config, graph, inputs, params, fused, planned)
    prepared = ref.prepare(cell.config, graph, "cpu")
    want = harness.host_readings(dict(zip(
        ("losses", "grad1", "change"),
        ref.train(cell.config, prepared, inputs, params, 3))))
    assert set(got["grad1"]) == set(want["grad1"]) == \
        {name for name, *_ in spec} | {"x"}
    gaps = check.gaps(got, want)
    assert all(v < 2e-5 for v in gaps.values()), gaps
    # the three losses move: the steps did train
    assert len(set(want["losses"])) == 3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_triangle_weights_match_the_reference(seed):
    g = tiny_graph(seed=seed, nodes=300, positive=2500, negative=700,
                   stub_factor=1.5)
    es = np.vstack([g["edge_index"], g["edge_sign"]]).T
    pos, neg = ref.signed_pairs(g)
    c_pos, c_neg = ref.triangle_weights(pos, neg, g["num_nodes"])
    _, W = motifs.sdgnn_edge_lists(es, g["num_nodes"])
    np.testing.assert_array_equal(
        np.asarray(W[pos[0], pos[1]]).ravel(), c_pos)
    np.testing.assert_array_equal(
        np.asarray(W[neg[0], neg[1]]).ravel(), c_neg)
    assert (c_pos > 0).sum() > 0.3 * len(c_pos)


def test_the_reference_refuses_a_pair_with_both_signs():
    pos = np.array([[0, 1], [1, 2]])
    neg = np.array([[0], [1]])
    with pytest.raises(ValueError, match="both signs"):
        ref.triangle_weights(pos, neg, 3)


def test_the_device_draw_is_the_host_draw():
    traffic = dict(tiny_cell().traffic, nodes=20_000, positive=60_000,
                   negative=15_000)
    host = signed_powerlaw.generate(traffic, 2 ** 31 + 3)
    dev = signed_powerlaw.generate(traffic, 2 ** 31 + 3, device="cpu")
    for key in ("edge_index", "edge_sign"):
        np.testing.assert_array_equal(host[key], dev[key])


def test_epinions_counts_at_seed_0():
    traffic = harness.Cell.find(harness.ROOT, CELL).traffic
    g = signed_powerlaw.generate(traffic, 0, device="cpu")
    ei, sign, n = g["edge_index"], g["edge_sign"], g["num_nodes"]
    assert n == 131_580
    assert (sign > 0).sum() == 589_888 and (sign < 0).sum() == 121_322
    assert ei.shape[1] == traffic["counts_at_seed_0"]["edges"]
    keys = ei[0] * n + ei[1]
    assert (np.diff(keys) > 0).all()            # distinct, in key order
    assert (ei[0] != ei[1]).all() and ei.max() < n
    assert np.bincount(ei[0]).max() == \
        traffic["counts_at_seed_0"]["largest_out_degree"]


def test_the_generator_follows_the_seed():
    a, b = tiny_graph(seed=5), tiny_graph(seed=5)
    c = tiny_graph(seed=6)
    np.testing.assert_array_equal(a["edge_index"], b["edge_index"])
    np.testing.assert_array_equal(a["edge_sign"], b["edge_sign"])
    assert not np.array_equal(a["edge_index"], c["edge_index"])
    assert a["edge_index"].shape == c["edge_index"].shape == (2, 2500)


def _signed_matrix(n, seed):
    rng = np.random.default_rng(seed)
    M = sp.random(n, n, density=0.02, random_state=seed, format="csr")
    M = sp.csr_matrix(M + M.T)
    M.data = np.sign(rng.standard_normal(M.nnz))
    return M


@pytest.mark.parametrize("seed", [0, 1])
def test_torch_range_finder_spans_the_numpys_subspace(seed):
    n, dim = 400, 16
    M = _signed_matrix(n, seed)
    want = features.randomized_svd_components(M, dim, random_state=seed)
    Q = np.random.RandomState(seed).normal(size=(n, dim + 10))
    got = features._range_finder_torch(M, Q, dim, 128, torch.device("cpu"))
    assert got.dtype == torch.float64 and got.shape == (dim, n)
    angles = scipy.linalg.subspace_angles(want.T, got.numpy().T)
    assert angles.max() < 1e-8


def test_lu_permute_l_is_scipys():
    A = torch.randn(300, 12, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    want, _ = scipy.linalg.lu(A.numpy(), permute_l=True)
    np.testing.assert_allclose(features._lu_permute_l(A).numpy(), want,
                               rtol=0, atol=1e-13)


def test_spectral_features_on_the_cpu_stay_numpy():
    pos = np.array([[0, 1, 2, 3], [1, 2, 3, 4]])
    neg = np.array([[4, 0], [0, 2]])
    a = features.create_spectral_features(pos, neg, 5, 2, seed=1)
    b = features.create_spectral_features(pos, neg, 5, 2, seed=1,
                                          device="cpu")
    assert isinstance(b, np.ndarray) and b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def plant(monkeypatch, fault, fused):
    """Break the port underneath the harness: AdamW's step a no-op, each
    loss over half its edges, or the first 1/32 of the rows of every
    attention aggregate doubled (of each motif's, on the stack)."""
    if fault == "state":
        monkeypatch.setattr(torch.optim.AdamW, "step",
                            lambda self, closure=None: None)
    elif fault == "half":
        loss = SDGNN.loss

        def first(e, k):
            if isinstance(e, link_sign_loss.PlannedEdges):
                both = torch.stack([e.src.index, e.dst.index])[:, :k]
                return link_sign_loss.plan_edges(
                    both, e.src.plan.num_rows, both.device)
            return e[:, :k]

        def half(self, graphs, pos, neg, w_pos, w_neg):
            p, q = pos.shape[1] // 2, neg.shape[1] // 2
            return loss(self, graphs, first(pos, p), first(neg, q),
                        w_pos[:p], w_neg[:q])

        monkeypatch.setattr(SDGNN, "loss", half)
    elif fused:
        attend = motif_stack.motif_attend

        def altered_stack(slope, ms, *a):
            out = attend(slope, ms, *a).view(ms.num_graphs, ms.num_nodes, -1)
            rows = max(1, ms.num_nodes // 32)
            return torch.cat([2.0 * out[:, :rows], out[:, rows:]], 1).view(
                ms.num_graphs * ms.num_nodes, -1)

        monkeypatch.setattr(motif_stack, "motif_attend", altered_stack)
    else:
        aggregate = snea_conv.attention_softmax_aggregate

        def altered(*a, **k):
            out = aggregate(*a, **k)
            rows = max(1, out.shape[0] // 32)
            return torch.cat([2.0 * out[:rows], out[rows:]])

        monkeypatch.setattr(snea_conv, "attention_softmax_aggregate",
                            altered)


def run(fused, traced=False):
    return harness.run_cell(tiny_cell(fused), SEED, 0.2, traced, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("fused", [True, False])
def test_the_cell_is_correct_at_a_tiny_size(fused):
    r, run_, _ = run(fused, traced=True)
    assert r["correct"], r["check"]
    assert run_.flops_per_epoch > 0
    widths = [a.width for a in run_.applies_per_epoch]
    # the GATs' sums, then the backward of the losses' 12 gathers of z
    assert widths == ([33, 33, 1] * 2 if fused else [33] * 8) + [32] * 12
    assert "spmm_calls_per_epoch" in r["metrics"]


def test_the_cell_refuses_a_port_without_planned_edges(monkeypatch):
    """A port without ``plan_edges`` (an older one) cannot run the
    configuration: the program refuses it before the set-up."""
    monkeypatch.delattr(link_sign_loss, "plan_edges")
    monkeypatch.setattr(sdgnn, "prepare_sdgnn_inputs", None)
    with pytest.raises(RuntimeError, match="plan_edges"):
        run(True)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("fault", ["state", "half", "answer"])
def test_check_fails_on_a_fault(fault, fused, monkeypatch):
    plant(monkeypatch, fault, fused)
    r, _, _ = run(fused)
    assert not r["correct"], r["check"]


def test_attends_count_the_gat_aggregates():
    graph = tiny_graph()
    es = np.vstack([graph["edge_index"], graph["edge_sign"]]).T
    n = graph["num_nodes"]
    for fused in (False, True):
        _, _, emb, graphs, _, _ = sdgnn.prepare_sdgnn_inputs(
            n, es, 8, init_emb=np.zeros((n, 8)), fused=fused, device="cpu")
        model = SDGNN(n, 8, 8, init_emb=emb, fused=fused, device="cpu")
        reset_counts()
        model(graphs)
        assert snea_conv.ATTENDS == {"mxu": 8, "segment": 0}


def test_a_stack_step_counts_its_sums(monkeypatch):
    """One SDGNN step on the motif stack with planned edges, as the cell
    runs it: 18 K1 sums (a layer's attend forward, by source and by
    destination; the backward of the losses' 12 gathers), 16 of them
    reading their messages by index (all but the W=1 sums by
    destination), and the edge kernel once a layer.  The CPU runs the
    plain versions, which count nothing: the calls are counted here."""
    from pytorch_geometric_signed_directed_tpu_torch.ops import scatter
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        scatter_csr)

    counts = {"csr_scatter_sum": 0, "csr_scatter_sum_indexed": 0,
              "attend_logit_grad": 0}

    def counted(fn, key):
        def call(*args, **kw):
            counts[key] += 1
            if key == "csr_scatter_sum" and kw.get("index") is not None:
                counts["csr_scatter_sum_indexed"] += 1
            return fn(*args, **kw)
        return call

    for mod in (motif_stack, scatter):
        monkeypatch.setattr(mod, "csr_scatter_sum", counted(
            scatter_csr.csr_scatter_sum, "csr_scatter_sum"))
    monkeypatch.setattr(motif_stack, "attend_logit_grad", counted(
        motif_stack.attend_logit_grad, "attend_logit_grad"))
    graph = tiny_graph()
    n = graph["num_nodes"]
    es = np.vstack([graph["edge_index"], graph["edge_sign"]]).T
    pos, neg, emb, graphs, w_pos, w_neg = sdgnn.prepare_sdgnn_inputs(
        n, es, 8, init_emb=np.zeros((n, 8)), fused=True, device="cpu")
    model = SDGNN(n, 8, 8, init_emb=emb, fused=True, device="cpu")
    model.loss(graphs, *(link_sign_loss.plan_edges(e, n, "cpu")
                         for e in (pos, neg)),
               torch.as_tensor(w_pos), torch.as_tensor(w_neg)).backward()
    assert counts == {"csr_scatter_sum": 18, "csr_scatter_sum_indexed": 16,
                      "attend_logit_grad": 2}


def test_scatter_readers():
    fams = trace.load_families(harness.ROOT)
    ops = [("csr_span_kernel", 0.0, 30.0), ("csr_walk_kernel", 30.0, 40.0),
           ("combine_pieces_kernel", 40.0, 50.0),
           ("void csr_rows_kernel<DualSource<float>>", 50.0, 90.0)]
    s = cost_scatter.Scatter(rows=1000, nnz=5000, width=33)
    assert cost_scatter.scatter_bytes(s) == \
        4 * 1001 + 4 * 5000 * 33 + 4 * 1000 * 33
    assert cost_scatter.scatter_flops(s) == 5000 * 33
    run_ = harness.Run(trace=trace.Trace(ops, [], fams), traced_epochs=2,
                       traced_epoch_s=[1e-3, 1e-3], flops_per_epoch=6.7e9,
                       applies_per_epoch=[s, s], calls_per_epoch=2.0)

    def read(name, r=run_):
        return harness.load_module(harness.ROOT, "metrics", name).read(r)

    # the scatter kernels' 40 us, not the combine's or K1's dual
    assert read("scatter_roofline") == pytest.approx(
        100 * 4 * cost_scatter.scatter_bound_s(s) / 40e-6)
    assert read("mfu") == pytest.approx(10.0)
    assert read("spmm_calls_per_epoch") == 2.0
    empty = harness.Run()
    for name in ("scatter_roofline", "mfu"):
        assert read(name, empty) is None


def test_planned_edges_give_the_losses_of_the_edge_lists():
    """The link-sign losses on ``PlannedEdges`` against the same edge
    lists as tensors: values and the embedding's gradient."""
    graph = tiny_graph()
    n = graph["num_nodes"]
    ei = torch.as_tensor(graph["edge_index"])
    pos, neg = ei[:, graph["edge_sign"] > 0], ei[:, graph["edge_sign"] < 0]
    planned = [link_sign_loss.plan_edges(e, n, "cpu") for e in (pos, neg)]
    assert planned[0].shape == (2, pos.shape[1])
    gen = torch.Generator().manual_seed(0)
    direction = link_sign_loss.Sign_Direction_Loss(8, generator=gen,
                                                   device="cpu")
    triangle = link_sign_loss.Sign_Triangle_Loss(8, generator=gen,
                                                 device="cpu")
    w = [torch.rand(e.shape[1], generator=gen) for e in (pos, neg)]
    z0 = torch.randn(n, 8, generator=gen)

    def losses(p, q):
        z = z0.clone().requires_grad_(True)
        out = [link_sign_loss.sign_product_entropy_loss(z, p, q),
               direction(z, p, q), triangle(z, p, q, *w),
               link_sign_loss.link_sign_product_loss(z, p, q)]
        sum(out).backward()
        return torch.stack(out).detach(), z.grad

    (a, ga), (b, gb) = losses(pos, neg), losses(*planned)
    torch.testing.assert_close(b, a, rtol=1e-6, atol=0)
    torch.testing.assert_close(gb, ga, rtol=1e-5,
                               atol=1e-6 * float(ga.abs().max()))


def test_the_experiment_runs_sdgnn_on_the_stack_with_planned_edges():
    from pytorch_geometric_signed_directed_tpu_torch.experiments import (
        _signed_embedding)

    graph = tiny_graph()
    es = np.vstack([graph["edge_index"], graph["edge_sign"]]).T
    emb = _signed_embedding.embedding_model(
        "sdgnn", graph["num_nodes"], es, 8, 8, 0, "cpu")
    assert isinstance(emb.fwd[0], motif_stack.MotifStackGraph)
    args = emb.samples()
    assert all(isinstance(e, link_sign_loss.PlannedEdges)
               for e in args[1:3])
    assert args is emb.samples()
    run_ = _signed_embedding.train_embedding(emb, 2, 1e-2, 1e-5, "cpu")
    assert len(run_["losses"]) == 2 and run_["z"].shape == (
        graph["num_nodes"], 8)
    assert np.isfinite(run_["losses"]).all()
