"""The port stands alone: it imports torch, never JAX or the JAX package,
and it runs on the card unless the caller asks for the CPU."""
import ast
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "pytorch_geometric_signed_directed_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax",
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
    from pytorch_geometric_signed_directed_tpu_torch.nn import (
        MagNetConv, MagNet_node_classification)
    from pytorch_geometric_signed_directed_tpu_torch.ops import (
        build_coo, dual_propagator, make_propagator)
    from pytorch_geometric_signed_directed_tpu_torch.spectral import (
        magnet_propagators)
    from pytorch_geometric_signed_directed_tpu_torch.train import Trainer

    ei = np.array([[0, 1, 2], [1, 2, 0]])
    one = np.ones(3)
    return {
        "magnet_propagators": lambda **kw: magnet_propagators(ei, **kw),
        "make_propagator": lambda **kw: make_propagator(ei[0], ei[1], **kw),
        "dual_propagator": lambda **kw: dual_propagator(
            ei[0], ei[1], one, one, mode="segment", **kw),
        "build_coo": lambda **kw: build_coo(ei[0], ei[1], **kw),
        "MagNetConv": lambda **kw: MagNetConv(2, 2, 1, **kw),
        "MagNet_node_classification":
            lambda **kw: MagNet_node_classification(2, **kw),
        "Trainer": lambda **kw: Trainer(lambda m: 0, **kw),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_the_card(name, monkeypatch):
    make = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    assert make(device="cpu") is not None
