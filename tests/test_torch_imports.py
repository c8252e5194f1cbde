"""The port stands alone: it imports torch, never JAX or the JAX package,
and it runs on the card unless the caller asks for the CPU."""
import ast
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "pytorch_geometric_signed_directed_tpu_torch"
# the card's machine has no scikit-learn, so the port does without it
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sklearn",
             "pytorch_geometric_signed_directed_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(p.relative_to(ROOT)), m) for p in files
           for m in _imports(p) if _forbidden(m)]
    assert bad == []


def test_the_prefix_rule_does_not_match_the_port_itself():
    assert _forbidden("pytorch_geometric_signed_directed_tpu.ops")
    assert not _forbidden("pytorch_geometric_signed_directed_tpu_torch")
    assert not _forbidden("pytorch_geometric_signed_directed_tpu_torch.nn")


def _entry_points():
    from pytorch_geometric_signed_directed_tpu_torch import graph
    from pytorch_geometric_signed_directed_tpu_torch.experiments import run
    from pytorch_geometric_signed_directed_tpu_torch.nn import (
        DGCN_link_prediction, DGCN_node_classification,
        DIGRAC_node_clustering, DIMPA, DiGCN_Inception_Block,
        DiGCN_Inception_Block_link_prediction,
        DiGCN_Inception_Block_node_classification, DiGCN_link_prediction,
        DiGCN_node_classification, DiGCNConv, MSConv, MSGNN_link_prediction,
        MSGNN_node_classification, MagNetConv, MagNet_node_classification)
    from pytorch_geometric_signed_directed_tpu_torch.ops import (
        build_coo, dual_propagator, make_propagator)
    from pytorch_geometric_signed_directed_tpu_torch.parallel import (
        local_mesh, make_mesh)
    from pytorch_geometric_signed_directed_tpu_torch.spectral import (
        magnet_operator_arrays, magnet_propagators, magnetic_pair,
        magnetic_template)
    from pytorch_geometric_signed_directed_tpu_torch.train import Trainer

    ei = np.array([[0, 1, 2], [1, 2, 0]])
    one = np.ones(3)

    def experiment(name, *argv):
        def go(device=None):
            dev = [] if device is None else ["--device", device]
            return run(name, [*argv, "--epochs", "1", *dev])
        return go

    synthetic = ("--dataset", "synthetic", "--num_nodes", "40")

    return {
        "magnet_propagators": lambda **kw: magnet_propagators(ei, **kw),
        "magnetic_template": lambda **kw: magnetic_template(ei, **kw),
        "make_mesh": lambda **kw: make_mesh(**kw),
        "local_mesh": lambda **kw: local_mesh(**kw),
        "make_propagator": lambda **kw: make_propagator(ei[0], ei[1], **kw),
        "dual_propagator": lambda **kw: dual_propagator(
            ei[0], ei[1], one, one, mode="segment", **kw),
        "build_coo": lambda **kw: build_coo(ei[0], ei[1], **kw),
        "MagNetConv": lambda **kw: MagNetConv(2, 2, 1, **kw),
        "MagNetConv(trainable_q)": lambda **kw: MagNetConv(
            2, 2, 1, trainable_q=True, **kw),
        "MagNet_node_classification":
            lambda **kw: MagNet_node_classification(2, **kw),
        "Trainer": lambda **kw: Trainer(lambda m: 0, **kw),
        "magnetic_pair": lambda **kw: magnetic_pair(
            *magnet_operator_arrays(ei), **kw),
        "MSConv": lambda **kw: MSConv(2, 2, 1, **kw),
        "MSGNN_node_classification":
            lambda **kw: MSGNN_node_classification(4, **kw),
        "MSGNN_link_prediction": lambda **kw: MSGNN_link_prediction(4, **kw),
        "experiment magnet_node": experiment("magnet_node", *synthetic),
        "experiment magnet_link": experiment("magnet_link", *synthetic,
                                             "--splits", "1"),
        "experiment msgnn_node": experiment("msgnn_node", *synthetic),
        "experiment msgnn_link": experiment("msgnn_link", *synthetic),
        "experiment digrac": experiment("digrac", "--N", "60"),
        "experiment dgcn_link": experiment("dgcn_link", *synthetic,
                                           "--splits", "1"),
        "experiment digcn_link": experiment("digcn_link", *synthetic,
                                            "--splits", "1"),
        "experiment digcn_inception_link": experiment(
            "digcn_inception_link", *synthetic, "--splits", "1"),
        "gcn_norm_propagator": lambda **kw: graph.gcn_norm_propagator(
            ei, **kw),
        "norm_propagator": lambda **kw: graph.norm_propagator(ei, one, **kw),
        "rw_norm_propagator": lambda **kw: graph.rw_norm_propagator(ei, **kw),
        "rw_norm_dual_propagator":
            lambda **kw: graph.rw_norm_dual_propagator(ei, **kw),
        "adj_dual_propagator":
            lambda **kw: graph.adj_dual_propagator(ei, **kw),
        "DIMPA": lambda **kw: DIMPA(2, **kw),
        "DIGRAC_node_clustering":
            lambda **kw: DIGRAC_node_clustering(2, 4, 3, **kw),
        "DiGCNConv": lambda **kw: DiGCNConv(2, 4, **kw),
        "DiGCN_node_classification":
            lambda **kw: DiGCN_node_classification(2, 4, 3, **kw),
        "DiGCN_link_prediction":
            lambda **kw: DiGCN_link_prediction(2, 4, 2, **kw),
        "DiGCN_Inception_Block":
            lambda **kw: DiGCN_Inception_Block(2, 4, **kw),
        "DiGCN_Inception_Block_node_classification":
            lambda **kw: DiGCN_Inception_Block_node_classification(
                2, 4, 3, **kw),
        "DiGCN_Inception_Block_link_prediction":
            lambda **kw: DiGCN_Inception_Block_link_prediction(2, 4, 2, **kw),
        "DGCN_node_classification":
            lambda **kw: DGCN_node_classification(2, 4, 3, **kw),
        "DGCN_link_prediction":
            lambda **kw: DGCN_link_prediction(2, 4, 2, **kw),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_the_card(name, monkeypatch):
    make = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    assert make(device="cpu") is not None
