"""On the card: a cell run end to end, and the check's control (the port
with TF32 allowed, one precision below the configurations' float32)
coming out not correct, on three seeds.

Run on the card from the root of the checkout:

    python3 -m pytest port_bench/tests/test_port_bench_card.py -m cuda
"""
import time

import pytest
import torch

from port_bench import calibrate, check, harness

SEEDS = (11, 12, 13)
WORKLOADS = ("magnet_node.giant_powerlaw", "digrac.giant_powerlaw")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(card):
    cell = harness.Cell.find(harness.ROOT, "digrac.giant_powerlaw")
    for traced in (False, True):
        r, _, _ = harness.run_cell(cell, 21, 1.0, traced, card,
                                   time.perf_counter())
        assert r["correct"], r["check"]
        assert r["metrics"]
        if traced:
            assert r["device"]["busy_s"] > 0
            assert set(r["metrics"]) == {
                "prep_s", "dispatch_ms", "spmm_calls_per_epoch",
                "spmm_roofline", "mfu", "idle_share"}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_the_check(workload, card):
    """At the cell's own size (about a minute a seed on the giant
    graph)."""
    cell = harness.Cell.find(harness.ROOT, workload)
    limits = harness.limits_for(cell)
    for seed in SEEDS:
        got = calibrate.seed_readings(
            cell, seed, card,
            variants={k: calibrate.VARIANTS[k]
                      for k in ("sound", "control_tf32")}, faults=())
        assert check.judge(got["gaps"]["sound"], limits)[0], got
        assert not check.judge(got["gaps"]["control_tf32"], limits)[0], got
