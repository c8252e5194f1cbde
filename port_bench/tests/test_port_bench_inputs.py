"""The frozen generators reproduce the counts the port's runs report at
seed 0, and the byte and operation functions give chip_smoke.py's bound
from an operator's shapes alone."""
import numpy as np
import pytest
import torch

from port_bench import cost, harness
from port_bench.gen import dsbm, powerlaw_digraph


def test_frozen_generator_gives_chip_smokes_count():
    """chip_smoke.py's giant graph: 2,400,000 nodes, 10,000,000 draws."""
    row, col = powerlaw_digraph.powerlaw_digraph(2_400_000, 10_000_000,
                                                 1.0, 0)
    assert len(row) == len(col) == 9_929_144


def test_giant_powerlaw_edges_at_seed_0():
    """WikiTalk's node count, and its distinct edges (5,018,445) within
    0.01% at seed 0, every edge once."""
    traffic = harness.load_json(f"{harness.ROOT}/port_bench/traffic/"
                                "giant_powerlaw.json")
    g = powerlaw_digraph.generate(traffic, 0)
    ei, n = g["edge_index"], g["num_nodes"]
    assert n == 2_388_953
    assert ei.shape[1] == traffic["counts_at_seed_0"]["edges"] == 5_018_203
    assert abs(ei.shape[1] / 5_018_445 - 1) < 1e-4
    assert len(np.unique(ei[0] * n + ei[1])) == ei.shape[1]
    assert (ei[0] != ei[1]).all() and ei.max() < n
    assert np.bincount(g["labels"]).argmax() == 0


@pytest.mark.parametrize("distinct", [False, True])
def test_the_device_draw_is_the_host_draw(distinct):
    traffic = harness.load_json(f"{harness.ROOT}/port_bench/traffic/"
                                "giant_powerlaw.json")
    traffic.update(distinct=distinct)
    if not distinct:
        traffic.update(nodes=50_000, draws=400_000)
    host = powerlaw_digraph.generate(traffic, 2 ** 31 + 3)
    dev = powerlaw_digraph.generate(traffic, 2 ** 31 + 3, device="cpu")
    assert np.array_equal(host["edge_index"], dev["edge_index"])
    assert np.array_equal(host["labels"], dev["labels"])


def test_dsbm_flat_edges_at_seed_0():
    traffic = harness.load_json(f"{harness.ROOT}/port_bench/traffic/"
                                "dsbm_flat.json")
    g = dsbm.generate(traffic, 0)
    assert g["edge_index"].shape[1] == 2_456_932
    assert sorted(np.unique(g["labels"])) == [0, 1, 2, 3, 4]


def test_the_generators_follow_the_seed():
    traffic = dict(generator="powerlaw_digraph", nodes=5000, draws=20000,
                   alpha=1.0, label_freq=[0.5, 0.5])
    a, b = (powerlaw_digraph.generate(traffic, 2 ** 31 + 5)
            for _ in range(2))
    c = powerlaw_digraph.generate(traffic, 2 ** 31 + 6)
    assert np.array_equal(a["edge_index"], b["edge_index"])
    assert np.array_equal(a["labels"], b["labels"])
    assert not np.array_equal(a["edge_index"][:, :100],
                              c["edge_index"][:, :100])


def test_k1_bound_of_magnet_mxu_at_2f_64():
    """chip_smoke.py's bound for magnet_mxu's K1 call at 2F=64: 0.0279 ms
    (N=65,536, a 4,978,460-nnz dual, f32)."""
    a = cost.Apply(rows=65_536, cols=65_536, nnz=4_978_460, values=2,
                   width=64)
    ms, by = cost.bound(cost.apply_bytes(a), cost.apply_flops(a))
    assert by == "bytes"
    assert round(ms, 4) == 0.0279
    assert cost.apply_bound_s(a) == pytest.approx(ms / 1e3)


def test_apply_bytes_are_the_operators_arrays():
    """An apply's bytes are those of the port's flat dual (rowptr, col,
    both value arrays) plus x read once and the output written once."""
    from pytorch_geometric_signed_directed_tpu_torch.spectral import (
        magnet_propagators)

    traffic = dict(generator="dsbm", nodes=9000, clusters=5,
                   meta_graph="cyclic", eta=0.05, ambient=False,
                   avg_degree=5, p_factor=2.5)
    g = dsbm.generate(traffic, 3)
    D = magnet_propagators(g["edge_index"], g["edge_weight"], q=0.2,
                           num_nodes=9000, mode="mxu", device="cpu").dual
    assert D.rowptr is not None and not D.blocks
    width = 128
    arrays = sum(t.numel() * t.element_size()
                 for t in (D.rowptr, D.col, D.val_a, D.val_b))
    x = torch.zeros(9000, width)
    a = cost.Apply(D.num_nodes, D.num_cols, D.col.numel(), 2, width)
    assert cost.apply_bytes(a) == arrays + 2 * x.numel() * x.element_size()
    assert cost.apply_flops(a) == 2 * D.col.numel() * width
