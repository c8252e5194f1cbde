"""The port's spans (``instrument``) on the CPU: off they leave no
trace and build no autograd node; on they reach the backward through the
markers and change no number; the set-up spans; ``trace``; the
attribution of device operations to spans, eager through the profiler's
correlation and replayed through a capture's span table; and the span
report's arithmetic."""
import importlib.util
import pathlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pytorch_geometric_signed_directed_tpu_torch import instrument
from pytorch_geometric_signed_directed_tpu_torch.graph import (
    adj_dual_propagator, rw_norm_dual_propagator)
from pytorch_geometric_signed_directed_tpu_torch.nn import (
    SDGNN, DIGRAC_node_clustering, MagNet_node_classification)
from pytorch_geometric_signed_directed_tpu_torch.nn.signed.sdgnn import (
    prepare_sdgnn_inputs)
from pytorch_geometric_signed_directed_tpu_torch.ops import spmm
from pytorch_geometric_signed_directed_tpu_torch.spectral import (
    magnet_propagators)
from pytorch_geometric_signed_directed_tpu_torch.train import (
    adam, masked_nll, profiling)
from pytorch_geometric_signed_directed_tpu_torch.utils import (
    Prob_Imbalance_Loss)
from test_torch_worker_memory import release_memory  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 60
CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


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


@pytest.fixture(autouse=True)
def spans_off_after():
    yield
    instrument.set_tracing(False)
    instrument.drain()


def _graph():
    rng = np.random.default_rng(0)
    ei = rng.integers(0, N, (2, 300))
    ei = ei[:, ei[0] != ei[1]]
    x = torch.from_numpy(rng.random((N, 2)).astype(np.float32))
    return ei, np.ones(ei.shape[1]), x, torch.from_numpy(
        rng.integers(0, 3, N))


def magnet_step(steps=1):
    """A tiny MagNet (K=2, two layers, dropout) on the kernel tier: its
    losses, last gradients, the last loss and the step's profile."""
    ei, w, x, y = _graph()
    lap = magnet_propagators(ei, w, q=0.25, num_nodes=N, mode="mxu",
                             device="cpu")
    model = MagNet_node_classification(
        2, hidden=4, K=2, label_dim=3, activation=True, layer=2,
        dropout=0.5, device="cpu", generator=torch.Generator().manual_seed(0))
    opt = adam(1e-2, 5e-4)(model.parameters())
    gen = torch.Generator().manual_seed(1)

    def loss_fn():
        return masked_nll(model(x, x, lap, True, gen), y, torch.ones(N))

    return _steps(model, opt, loss_fn, steps)


def digrac_step(steps=1):
    """A tiny DIGRAC on the fused walk and adjacency duals, with the
    imbalance loss."""
    ei, w, x, _ = _graph()
    walk = rw_norm_dual_propagator(ei, w, N, fill_value=0.5, device="cpu")
    adj = adj_dual_propagator(ei, w, N, device="cpu")
    model = DIGRAC_node_clustering(
        2, hidden=4, nclass=3, dropout=0.5, hop=2, device="cpu",
        generator=torch.Generator().manual_seed(0))
    opt = adam(1e-2)(model.parameters())
    gen = torch.Generator().manual_seed(1)
    loss = Prob_Imbalance_Loss(3)

    def loss_fn():
        prob = model(walk, None, x, True, gen)[3]
        return loss(prob, adj, 3, "vol_sum", "sort")

    return _steps(model, opt, loss_fn, steps)


def sdgnn_step(steps=1):
    """A tiny SDGNN (width 4, two layers, four motif GATs a layer on K1)
    on its three losses, trained with AdamW."""
    rng = np.random.default_rng(0)
    ei, _, _, _ = _graph()
    es = np.vstack([ei, rng.choice([-1, 1], ei.shape[1], p=[0.2, 0.8])]).T
    pos, neg, emb, graphs, w_pos, w_neg = prepare_sdgnn_inputs(
        N, es, 4, init_emb=rng.standard_normal((N, 4)), device="cpu")
    model = SDGNN(N, 4, 4, init_emb=emb, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    opt = adam(1e-2, 1e-5, decoupled=True)(model.parameters())
    args = (graphs, torch.as_tensor(pos), torch.as_tensor(neg),
            torch.as_tensor(w_pos), torch.as_tensor(w_neg))
    return _steps(model, opt, lambda: model.loss(*args), steps)


def _steps(model, opt, loss_fn, steps):
    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            loss = loss_fn()
            loss.backward()
        losses.append(loss.detach().clone())
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        opt.step()
    return losses, grads, loss, prof


STEPS = {"magnet": magnet_step, "digrac": digrac_step,
         "sdgnn": sdgnn_step}


def _graph_nodes(loss):
    seen, todo, names = set(), [loss.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo += [f for f, _ in fn.next_functions]
    return names


def _spans(prof):
    return [e for e in prof.events() if e.name.startswith(instrument.PREFIX)]


@pytest.mark.parametrize("model", sorted(STEPS))
def test_spans_off_leave_no_event_and_no_marker(model, monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: opened.append(a))
    assert not instrument.tracing()
    _, _, loss, prof = STEPS[model]()
    assert _spans(prof) == []
    assert opened == []
    nodes = _graph_nodes(loss)
    assert nodes and not any("Mark" in n for n in nodes)
    assert instrument.drain() == []


@pytest.mark.parametrize("model", sorted(STEPS))
def test_spans_on_change_no_number(model):
    off = STEPS[model](steps=2)
    instrument.set_tracing(True)
    on = STEPS[model](steps=2)
    for a, b in zip(off[0], on[0]):
        assert torch.equal(a, b)
    assert off[1].keys() == on[1].keys()
    for k in off[1]:
        assert torch.equal(off[1][k], on[1][k]), k
    assert any("Mark" in n for n in _graph_nodes(on[2]))


def _names(events):
    return [instrument.parse_label(e.name)[0] for e in events]


def test_magnet_spans_reach_the_backward():
    instrument.set_tracing(True)
    _, _, _, prof = magnet_step()
    events = sorted(_spans(prof), key=lambda e: e.time_range.start)
    names = _names(events)
    # the forward: two convs of K=2 applies each (lanes 2F = 4, then 8)
    applies = [instrument.parse_label(e.name)[1] for e in events
               if e.name.startswith("pgsd.spmm.apply")]
    assert [a["width"] for a in applies] == [4, 4, 8, 8, 8, 8]
    assert all(a["layout"] == "flat" and a["rows"] == a["cols"] == N
               and a["values"] == 2 and a["elem"] == 4 and a["blocks"] == 0
               for a in applies)
    for name in ("nn.magnet_node", "nn.magnet_head", "nn.dropout",
                 "loss.masked_nll"):
        assert names.count(name) == names.count(name + ".backward") == 1
    assert names.count("nn.magnet_conv") == 2
    assert names.count("nn.magnet_conv.backward") == 2
    # the second conv's backward holds the two transposed applies; the
    # first conv's (its input needs no gradient) closes when the backward
    # pass ends, inside the model's backward
    convs = [e for e in events if e.name == "pgsd.nn.magnet_conv.backward"]
    model_bw = next(e for e in events
                    if e.name == "pgsd.nn.magnet_node.backward")
    late = [e for e in events if e.name.startswith("pgsd.spmm.apply")][4:]
    assert all(convs[0].time_range.start <= e.time_range.start
               and e.time_range.end <= convs[0].time_range.end
               for e in late)
    for c in convs:
        assert model_bw.time_range.start <= c.time_range.start
        assert c.time_range.end <= model_bw.time_range.end
    assert convs[1].time_range.start >= convs[0].time_range.end
    records = instrument.drain()
    assert sum(r.name == "nn.magnet_conv.backward" for r in records) == 2
    assert all(r.t0 <= r.t1 for r in records)


def test_digrac_spans_reach_the_backward():
    instrument.set_tracing(True)
    _, _, _, prof = digrac_step()
    events = sorted(_spans(prof), key=lambda e: e.time_range.start)
    names = _names(events)
    for name in ("nn.digrac", "nn.dimpa", "nn.digrac_head",
                 "loss.prob_imbalance"):
        assert names.count(name) == names.count(name + ".backward") == 1
    assert names.count("nn.digrac_mlp.backward") == 2
    assert names.count("nn.dropout.backward") == 2
    # the loss's apply runs inside the loss, forward and backward
    for span in ("pgsd.loss.prob_imbalance",
                 "pgsd.loss.prob_imbalance.backward"):
        loss = next(e for e in events if e.name == span)
        inner = [e for e in events if e.name.startswith("pgsd.spmm.apply")
                 and loss.time_range.start <= e.time_range.start
                 and e.time_range.end <= loss.time_range.end]
        assert [instrument.parse_label(e.name)[1]["width"]
                for e in inner] == [6]
    assert names.count("spmm.apply") == 6


def test_sdgnn_spans_reach_the_backward():
    instrument.set_tracing(True)
    _, _, _, prof = sdgnn_step()
    events = sorted(_spans(prof), key=lambda e: e.time_range.start)
    names = _names(events)
    for name in ("nn.sdgnn", "loss.sign_product", "loss.sign_direction",
                 "loss.sign_triangle"):
        assert names.count(name) == names.count(name + ".backward") == 1
    assert names.count("nn.sdr_layer") == 2
    assert names.count("nn.sdr_layer.backward") == 2
    convs = [instrument.parse_label(e.name)[1] for e in events
             if instrument.parse_label(e.name)[0] == "nn.gat_conv"]
    assert [a["motif"] for a in convs] == [0, 1, 2, 3] * 2
    assert all(a["rows"] == N and a["width"] == 5 for a in convs)
    assert convs[0]["nnz"] > N
    backward = [instrument.parse_label(e.name)[1] for e in events
                if instrument.parse_label(e.name)[0] ==
                "nn.gat_conv.backward"]
    assert sorted(a["motif"] for a in backward) == [0, 0, 1, 1, 2, 2, 3, 3]
    # every K1 call of the forward runs inside a GAT's span
    for e in events:
        if e.name.startswith("pgsd.kernel.csr_scatter_sum"):
            assert any(c.name.startswith("pgsd.nn.gat_conv(")
                       and c.time_range.start <= e.time_range.start
                       and e.time_range.end <= c.time_range.end
                       for c in events)


def test_sdgnn_setup_spans_are_recorded():
    instrument.set_tracing(True)
    ei, _, _, _ = _graph()
    es = np.vstack([ei, np.where(np.arange(ei.shape[1]) % 5, 1, -1)]).T
    prepare_sdgnn_inputs(N, es, 4, device="cpu")
    records = instrument.drain()
    assert [(r.name, r.attrs) for r in records
            if r.name.startswith("prep.")] == [
        ("prep.spectral_features", dict(rows=N, dim=4)),
        ("prep.motifs", dict(rows=N, graphs=4))]


def test_setup_spans_are_recorded():
    instrument.set_tracing(True)
    ei, w, _, _ = _graph()
    D = spmm.dual_propagator(ei[0], ei[1], w, w, N, mode="mxu",
                             device="cpu")
    adam(1e-2)([torch.nn.Parameter(torch.zeros(3))])
    records = instrument.drain()
    layouts = [r for r in records if r.name == "prep.layout"]
    assert [r.attrs for r in layouts] == [
        dict(rows=N, nnz=D.col.numel(), streamed=0)] * 2
    assert [r.name for r in records].count("train.optimizer_build") == 1
    assert all(r.t1 >= r.t0 for r in records)
    assert instrument.drain() == []


@pytest.mark.parametrize("before", [False, True])
def test_trace_turns_spans_on_for_its_block(before, tmp_path):
    instrument.set_tracing(before)
    ei, w, _, _ = _graph()
    with profiling.trace(str(tmp_path)) as prof:
        assert instrument.tracing()
        spmm.dual_propagator(ei[0], ei[1], w, w, N, mode="mxu",
                             device="cpu")
    assert instrument.tracing() is before
    assert any(e.name.startswith("pgsd.prep.layout") for e in prof.events())
    assert len(instrument.drain()) == (2 if before else 0)
    assert list(tmp_path.iterdir())


def test_label_round_trip():
    attrs = dict(layout="split", rows=8, nnz=12, values=2, width=64)
    assert instrument.parse_label(instrument.label("spmm.apply", attrs)) == (
        "spmm.apply", attrs)
    assert instrument.parse_label("pgsd.nn.dimpa.backward") == (
        "nn.dimpa.backward", {})
    assert instrument.parse_label("aten::add") is None



def test_reset_counts_zeroes_every_group():
    """One reset for the four counter groups; ``ops.cuda.launch_counts()``
    is the "kernels" group, under the keys it had before the registry."""
    from pytorch_geometric_signed_directed_tpu_torch.nn.directed import (
        magnet_conv)
    from pytorch_geometric_signed_directed_tpu_torch.nn.signed import (
        snea_conv)
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        attend_grad, bsr_spmm, complex_epilogue, dual_sddmm, launch_counts,
        scatter_csr)

    kernels = ["csr_dual_spmm", "csr_scatter_sum", "csr_dual_spmm_accum",
               "csr_scatter_accum", "csr_pair_spmm", "csr_pair_spmm_accum",
               "csr_scatter_sum_indexed", "bsr_spmm", "csr_dual_sddmm",
               "csr_dual_sddmm_accum", "attend_logit_grad"]
    assert list(launch_counts()) == kernels
    assert instrument.counts("kernels") == launch_counts()
    groups = {"kernels": [m.LAUNCHES for m in (scatter_csr, bsr_spmm,
                                                dual_sddmm, attend_grad)],
              "complex_epilogue": [complex_epilogue.LAUNCHES],
              "magnet_fused": [magnet_conv.FUSED_CALLS],
              "attends": [snea_conv.ATTENDS]}
    assert list(complex_epilogue.LAUNCHES) == ["complex_epilogue",
                                               "complex_epilogue_backward"]
    assert list(magnet_conv.FUSED_CALLS) == ["forward", "backward"]
    assert list(snea_conv.ATTENDS) == ["mxu", "segment"]
    for group in groups.values():
        for counts in group:
            for k in counts:
                counts[k] += 3
    before = launch_counts()
    assert min(before.values()) >= 3
    instrument.reset_counts()
    for name, group in groups.items():
        assert all(set(c.values()) == {0} for c in group), name
        assert set(instrument.counts(name).values()) == {0}, name
    assert set(launch_counts().values()) == {0}
    # launch_counts() hands out a copy: a reading taken before stays
    assert before["csr_scatter_sum"] >= 3

def test_capture_table_with_a_node_counter(monkeypatch):
    """Spans opened while the stream captures take the nodes made while
    they were open; a span on no capturing stream takes no row."""
    nodes = {"n": 0}
    capturing = {"on": True}
    monkeypatch.setattr(instrument, "_capture_stream",
                        lambda: 7 if capturing["on"] else None)
    monkeypatch.setattr(instrument, "_count", lambda stream: nodes["n"])

    def launch(k):
        nodes["n"] += k

    with instrument.capture_table() as table:
        assert table is None
    instrument.set_tracing(True)
    with instrument.capture_table() as table:
        launch(2)
        with instrument.span("nn.a"):
            launch(1)
            with instrument.span("spmm.apply", width=4):
                launch(3)
            capturing["on"] = False
            with instrument.span("nn.off"):
                pass
            capturing["on"] = True
        launch(1)
    assert table.nodes == 7
    assert table.rows == [instrument.SpanRow("nn.a", {}, 2, 6),
                          instrument.SpanRow("spmm.apply", {"width": 4}, 3, 6)]
    assert profiling.map_replay(7, table) == [(), (), (0,), (0, 1), (0, 1),
                                              (0, 1), ()]
    assert profiling.map_replay(6, table) is None


# ---------------------------------------------------------------------------
# Attribution from synthetic profiles


def _ev(name, start, end, thread=1, id=0, device=CPU):
    return SimpleNamespace(name=name, id=id, thread=thread, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=False)


def _eager_profile():
    """A forward thread (1): the loss holds an apply holding a kernel;
    the autograd thread (2): the loss's backward holds an apply; one
    operation launched outside every span; one launch with no record."""
    apply = "pgsd." + "spmm.apply(layout=split,rows=10,cols=10,nnz=20," \
        "values=2,width=4,elem=4,blocks=2)"
    return [
        _ev("pgsd.loss.prob_imbalance", 0, 100),
        _ev(apply, 10, 50),
        _ev("pgsd.kernel.csr_dual_spmm_accum(rows=10,nnz=20,width=4)",
            20, 30),
        _ev("cudaMemsetAsync", 12, 13, id=501),
        _ev("cudaLaunchKernel", 22, 23, id=502),
        _ev("cudaLaunchKernel", 60, 61, id=503),
        _ev("cudaLaunchKernel", 200, 201, id=504),
        _ev("pgsd.loss.prob_imbalance.backward", 300, 400, thread=2),
        _ev(apply, 310, 390, thread=2),
        _ev("cudaLaunchKernel", 320, 321, thread=2, id=505),
        _ev("Memset (Device)", 1000, 1010, id=501, device=CUDA),
        _ev("csr_rows_kernel<DualSource>", 1010, 1050, id=502, device=CUDA),
        _ev("reduce_kernel", 1050, 1060, id=503, device=CUDA),
        _ev("elementwise_kernel", 1060, 1064, id=504, device=CUDA),
        _ev("csr_rows_kernel<DualSource>", 1064, 1104, id=505, device=CUDA),
        _ev("orphan_kernel", 1104, 1106, id=999, device=CUDA),
        _ev("pgsd.loss.prob_imbalance", 1000, 1106, id=77, device=CUDA),
    ]


def test_attribute_eager_operations_through_correlation():
    att = profiling.attribute(_eager_profile())
    inner = {op.name + str(op.start): op.innermost and op.innermost.name
             for op in att.ops}
    assert inner == {"Memset (Device)1000": "spmm.apply",
                     "csr_rows_kernel<DualSource>1010":
                         "kernel.csr_dual_spmm_accum",
                     "reduce_kernel1050": "loss.prob_imbalance",
                     "elementwise_kernel1060": None,
                     "csr_rows_kernel<DualSource>1064": "spmm.apply",
                     "orphan_kernel1104": None}
    paths = [[s.name for s in op.spans] for op in att.ops]
    assert paths[1] == ["loss.prob_imbalance", "spmm.apply",
                        "kernel.csr_dual_spmm_accum"]
    assert paths[4] == ["loss.prob_imbalance.backward", "spmm.apply"]
    assert att.replays == 0 and len(att.spans) == 5
    assert att.spans[1].attr("width") == 4
    by = profiling.Attribution.by_span(att, epochs=2)
    assert by["spmm.apply"] == (1.0, pytest.approx((10 + 40) / 2e3))
    assert by["kernel.csr_dual_spmm_accum"] == (0.5, pytest.approx(0.02))
    assert by["loss.prob_imbalance"] == (0.5, pytest.approx(0.005))


def _replay_profile(n_ops, launches=2):
    out = [_ev("port_bench.dispatch", 0, 10_000)]
    for k in range(launches):
        corr = 900 + k
        out.append(_ev("cudaGraphLaunch", 100 * k, 100 * k + 5, id=corr))
        for i in reversed(range(n_ops)):      # out of order on purpose
            t = 1000 * (k + 1) + 10 * i
            out.append(_ev(f"op{i}", t, t + 10, id=corr, device=CUDA))
    return out


def _table():
    return instrument.SpanTable(rows=[
        instrument.SpanRow("nn.magnet_conv", {}, 0, 3),
        instrument.SpanRow("spmm.apply", dict(width=4), 1, 3),
        instrument.SpanRow("kernel.csr_dual_spmm_accum", dict(rows=3), 2, 3),
        instrument.SpanRow("nn.magnet_conv.backward", {}, 4, 5),
    ], nodes=5)


def test_map_replay_by_position():
    assert profiling.map_replay(5, _table()) == [
        (0,), (0, 1), (0, 1, 2), (), (3,)]
    assert profiling.map_replay(4, _table()) is None
    assert profiling.map_replay(6, _table()) is None


def test_attribute_replays_through_the_span_table(capsys):
    att = profiling.attribute(_replay_profile(5), _table())
    assert att.replays == 2
    assert [(op.name, op.innermost and op.innermost.name)
            for op in att.ops[:5]] == [
        ("op0", "nn.magnet_conv"), ("op1", "spmm.apply"),
        ("op2", "kernel.csr_dual_spmm_accum"), ("op3", None),
        ("op4", "nn.magnet_conv.backward")]
    by = att.by_span(epochs=2)
    assert by["spmm.apply"] == (1.0, pytest.approx(0.01))
    assert by["nn.magnet_conv.backward"] == (1.0, pytest.approx(0.01))
    assert capsys.readouterr().err == ""
    # a replay that ran another number of operations than the table
    # holds, or replays with no table: no attribution, one line why
    assert profiling.attribute(_replay_profile(6), _table()) is None
    assert "6 device operations" in capsys.readouterr().err
    assert profiling.attribute(_replay_profile(5)) is None
    assert "no span table" in capsys.readouterr().err


def _report():
    path = ROOT / "scripts" / "span_report_torch.py"
    spec = importlib.util.spec_from_file_location("span_report_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_span_report_quantities():
    report = _report()
    att = profiling.attribute(_eager_profile())
    records = [instrument.SpanRecord("prep.layout", {}, 0, 2_000_000_000, 1),
               instrument.SpanRecord("prep.layout", {}, 5, 500_000_005, 1),
               instrument.SpanRecord("train.optimizer_build", {}, 0,
                                    250_000_000, 1)]
    q = report.quantities(att, records, epochs=2)
    from port_bench import cost

    a = cost.Apply(10, 10, 20, 2, 4, 4)
    # inside the two applies: the memset, the kernel, the backward's kernel
    assert q["apply_roofline"] == pytest.approx(
        100 * 2 * cost.apply_bound_s(a) / ((10 + 40 + 40) / 1e6))
    assert q["apply_overhead_ms"] == pytest.approx((10 + 40) / 2e3)
    assert q["loss_ms"] == pytest.approx(10 / 2e3)
    assert q["layers_ms"] == 0
    assert q["layout_s"] == pytest.approx(2.5)
    assert q["optimizer_build_s"] == pytest.approx(0.25)
    assert q["covered"] == pytest.approx(100 / 106)
    assert report.top_ops(att, 2)[0] == ["kernel.csr_dual_spmm_accum",
                                         "csr_rows_kernel<DualSource>",
                                         pytest.approx(0.02)]


def test_span_report_runs_a_tiny_cell_on_the_cpu(capsys, monkeypatch):
    """The report's steps end to end on DIGRAC at 2,000 nodes on the CPU
    (stretches of 3 epochs): the set-up's spans, an epoch's spans and no
    device number."""
    import json

    from port_bench import harness

    monkeypatch.setattr(harness, "TRACE_EPOCHS", (3, 3))
    monkeypatch.setattr(harness, "WARMUP_S", 0.0)
    rc = _report().main(["--workload", "digrac.giant_powerlaw", "--seed",
                         str(2 ** 31 + 5), "--seconds", "0.1", "--device",
                         "cpu", "--tiny"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    spans = out["spans"]
    assert spans["spmm.apply"][0] == out["applies_per_epoch"] == 6
    for name in ("nn.digrac", "nn.dimpa.backward", "loss.prob_imbalance",
                 "loss.prob_imbalance.backward"):
        assert spans[name][0] == 1, name
    assert out["layout_s"] > 0 and out["optimizer_build_s"] > 0
    assert out["device_ms_per_epoch"] == 0 and out["covered"] is None
    assert [r["spans"] for r in out["cost"]] == [False, True, True, False]
    assert not instrument.tracing()


def test_span_report_reads_the_sdgnn_cell(capsys, monkeypatch):
    """The report on the SDGNN cell at 2,000 nodes on the CPU: its motif
    stacks, layers and losses an epoch, and the set-up's spectral
    features and motif lists."""
    import json

    from port_bench import harness

    monkeypatch.setattr(harness, "TRACE_EPOCHS", (3, 3))
    monkeypatch.setattr(harness, "WARMUP_S", 0.0)
    rc = _report().main(["--workload", "sdgnn.epinions_signed", "--seed",
                         str(2 ** 31 + 7), "--seconds", "0.1", "--device",
                         "cpu", "--tiny"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    spans = out["spans"]
    assert spans["nn.motif_gat_stack"][0] == 2
    assert spans["nn.motif_gat_stack.backward"][0] == 2
    assert spans["nn.sdr_layer"][0] == 2
    for name in ("nn.sdgnn", "loss.sign_product", "loss.sign_direction",
                 "loss.sign_triangle", "loss.sign_triangle.backward"):
        assert spans[name][0] == 1, name
    assert set(out["prep_spans_s"]) == {"prep.spectral_features",
                                        "prep.motifs"}
    assert all(v > 0 for v in out["prep_spans_s"].values())
    assert set(out["bench_spans_on"]) == {"idle_share", "mfu",
                                          "scatter_roofline"}
    assert not instrument.tracing()
