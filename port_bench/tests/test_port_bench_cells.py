"""Each cell's driver against its plain reference at a tiny size on the
CPU (the port's plain kernel versions), the check failing on the faults
a training cell can have, a run that finds no card, and a traffic file
added to a copy of the harness being found by name."""
import json
import os
import shutil
import sys
import time

import pytest
import torch

from port_bench import check, harness, trace

TINY = {"magnet_node.giant_powerlaw": dict(nodes=9000, draws=40000),
        "digrac.giant_powerlaw": dict(nodes=9000, draws=40000)}
SEED = 2 ** 31 + 17


def tiny(workload, root=harness.ROOT):
    cell = harness.Cell.find(root, workload)
    cell.traffic.update(TINY.get(workload, {}))
    return cell


def run(cell, traced=False, root=harness.ROOT):
    return harness.run_cell(cell, SEED, 0.2, traced, "cpu",
                            time.perf_counter(), root=root)


@pytest.mark.parametrize("workload", sorted(TINY))
def test_driver_agrees_with_reference(workload):
    r, run_, notes = run(tiny(workload))
    assert r["correct"], r["check"]
    assert all(v["value"] < 1e-5 for v in r["check"].values()), r["check"]
    assert r["attempted"] == run_.window_epochs >= 1
    assert set(r["metrics"]) >= {"train_edges_per_s", "setup_s"}


@pytest.fixture
def split_layouts(monkeypatch):
    """ops/layout.py's knobs lowered so that 9,000 nodes take the column
    split and the stream, as the giant graph does."""
    from pytorch_geometric_signed_directed_tpu_torch.ops import layout

    for knob, value in (("GATHER_FAST_ROWS", 512),
                        ("COL_SPLIT_MIN_COLS", 1000),
                        ("COL_SPLIT_MIN_COVERAGE", 0.0),
                        ("STREAM_THRESHOLD_EDGES", 20_000),
                        ("STREAM_BLOCK_EDGES", 15_000)):
        monkeypatch.setattr(layout, knob, value)


@pytest.mark.parametrize("workload", ["magnet_node.giant_powerlaw",
                                      "digrac.giant_powerlaw"])
def test_driver_agrees_on_split_and_streamed_layouts(workload,
                                                     split_layouts):
    r, run_, _ = run(tiny(workload), traced=True)
    assert r["correct"], r["check"]
    assert run_.applies_per_epoch and run_.flops_per_epoch > 0
    assert set(r["metrics"]) >= {"prep_s", "dispatch_ms"}


def plant(monkeypatch, fault, model):
    """Break the port's timed path underneath the harness ("masks": the
    port draws its dropout masks from another seed than the
    reference)."""
    from pytorch_geometric_signed_directed_tpu_torch.ops import spmm
    from pytorch_geometric_signed_directed_tpu_torch.train import (
        scan_trainer)
    from pytorch_geometric_signed_directed_tpu_torch.utils.directed import (
        prob_imbalance_loss)

    if fault == "masks":
        from port_bench.drivers import common

        make = common.dropout_generator
        monkeypatch.setattr(common, "dropout_generator", lambda inputs, dev:
                            make(dict(inputs, dropout_seed=inputs[
                                "dropout_seed"] + 1), dev))
    elif fault == "state":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    elif fault == "half" and model == "magnet_node":
        nll = scan_trainer.masked_nll

        def half_nll(logp, y, mask):
            keep = torch.arange(len(mask), device=mask.device) < \
                len(mask) // 2
            return nll(logp, y, mask * keep)

        monkeypatch.setattr(scan_trainer, "masked_nll", half_nll)
    elif fault == "half":
        cls = prob_imbalance_loss.Prob_Imbalance_Loss
        call = cls.__call__

        def half_call(self, P, *a, **k):
            keep = torch.arange(P.shape[0], device=P.device) < \
                P.shape[0] // 2
            return call(self, P * keep[:, None], *a, **k)

        monkeypatch.setattr(cls, "__call__", half_call)
    else:
        apply = spmm._layout_apply

        def altered(*a, **k):
            out = apply(*a, **k)
            rows = max(1, out.shape[0] // 32)
            return torch.cat([2.0 * out[:rows], out[rows:]])

        monkeypatch.setattr(spmm, "_layout_apply", altered)


@pytest.mark.parametrize("fault", ["state", "half", "answer", "masks"])
@pytest.mark.parametrize("workload", sorted(TINY))
def test_check_fails_on_a_fault(workload, fault, monkeypatch):
    cell = tiny(workload)
    plant(monkeypatch, fault, cell.config["model"])
    r, _, _ = run(cell)
    assert not r["correct"], r["check"]


def test_no_card_fails_before_any_metric(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "digrac.giant_powerlaw", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out == ""
    assert "no result" in out.err


def test_a_new_traffic_file_is_found_by_name(tmp_path):
    """A traffic mix added as one file to a copy of the harness, and a
    workload naming it (with its own limits file), run with no other
    edit: a flat DSBM graph on MagNet."""
    shutil.copytree(os.path.join(harness.ROOT, "port_bench"),
                    tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    bench["workloads"].append(dict(
        name="magnet_node.path_tiny", config="magnet_node",
        traffic="path_tiny", chips=1, why="a test's traffic"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(os.path.join(harness.ROOT, "port_bench", "limits",
                             "magnet_node.giant_powerlaw.json"),
                tmp_path / "port_bench" / "limits" /
                "magnet_node.path_tiny.json")
    (tmp_path / "port_bench" / "traffic" / "path_tiny.json").write_text(
        json.dumps(dict(generator="dsbm", nodes=8500, clusters=5,
                        meta_graph="path", eta=0.1, ambient=False,
                        avg_degree=3, p_factor=2.0)))
    cell = harness.Cell.find(str(tmp_path), "magnet_node.path_tiny")
    r, run_, _ = run(cell, traced=True, root=str(tmp_path))
    assert r["correct"], r["check"]
    assert run_.edges > 0
    assert run_.applies_per_epoch[0].nnz == run_.applies_per_epoch[-1].nnz


def test_check_gaps_and_limits():
    ref = dict(losses=[1.0, 0.9], grad1={"a": torch.ones(4),
                                         "b": torch.full((2,), 1e-9)},
               change={"a": torch.ones(4), "b": torch.ones(2)})
    same = check.gaps(ref, ref)
    assert same == dict(loss=0.0, grad=0.0, change=0.0)
    moved = dict(ref, change={"a": torch.zeros(4), "b": torch.ones(2)})
    assert check.gaps(moved, ref)["change"] == 1.0
    # leaf b's reference gradient is under a thousandth of the median's:
    # its change is not compared
    odd = dict(ref, change={"a": torch.ones(4), "b": torch.zeros(2)})
    assert check.gaps(odd, ref)["change"] == 0.0
    two = dict(ref, grad1={"a": torch.ones(4), "b": torch.ones(2)})
    one = dict(two, grad1={"a": torch.full((4,), 1.5), "b": torch.ones(2)})
    assert check.gaps(one, two)["grad"] == pytest.approx(0.5)
    nan = dict(ref, losses=[float("nan"), 0.9])
    ok, rows = check.judge(check.gaps(nan, ref),
                           dict(loss=1e-5, grad=1e-4, change=1e-3))
    assert not ok and rows["loss"]["value"] == sys.float_info.max


def test_trace_reading():
    fams = trace.load_families(harness.ROOT)
    ops = [("void csr_rows_kernel<DualSource<float>>", 10.0, 40.0),
           ("combine_pieces_kernel", 40.0, 50.0),
           ("csr_dual_sddmm_kernel<PairSource<float>>", 60.0, 70.0),
           ("elementwise", 80.0, 100.0)]
    spans = [("port_bench.dispatch", 0.0, 5.0), ("port_bench.wait", 50.0,
                                                  80.0)]
    t = trace.Trace(ops, spans, fams)
    assert t.busy_s == pytest.approx(70e-6)
    assert t.span_s == pytest.approx(100e-6)
    assert t.family_seconds(spmm=True) == pytest.approx(40e-6)
    assert t.family_seconds(spmm=False) == pytest.approx(10e-6)
    b = t.breakdown()
    assert b["device_ops"][0][0].startswith("[K1/K2 csr_dual_spmm")
    assert b["idle_gaps"][0] == ["host: dispatch", pytest.approx(10e-6)]
    assert {g[0] for g in b["idle_gaps"]} == {"host: dispatch",
                                              "host: wait"}


def test_readers_return_nothing_without_a_trace():
    r = harness.Run()
    for name in ("spmm_roofline", "mfu", "idle_share", "epoch_ms_p95",
                 "train_edges_per_s", "dispatch_ms"):
        assert harness.load_module(harness.ROOT, "metrics",
                                   name).read(r) is None
