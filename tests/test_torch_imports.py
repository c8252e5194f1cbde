"""The port stands alone: it imports torch, never JAX or the JAX package,
and it runs on the card unless the caller asks for the CPU."""
import ast
import os
import pathlib
import subprocess
import sys
import tempfile
from unittest import mock

import numpy as np
import pytest
import torch

from test_torch_worker_memory import release_memory  # noqa: F401

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


# the signed family's modules: each must exist and import nothing forbidden
SIGNED_MODULES = (
    "data/ssbm.py", "data/polarized_ssbm.py",
    "utils/general/extract_network.py", "utils/general/triplet_loss.py",
    "utils/signed/balanced_loss.py", "utils/signed/link_sign_loss.py",
    "spectral/features.py", "nn/signed/simpa.py", "nn/signed/sssnet.py",
    "nn/signed/sgcn_conv.py", "nn/signed/sgcn.py", "experiments/sssnet.py")


# the signed attention family's modules
ATTENTION_MODULES = (
    "ops/segment.py", "ops/scatter.py", "nn/signed/snea_conv.py",
    "nn/signed/snea.py", "nn/signed/gat_conv.py", "nn/signed/motifs.py",
    "nn/signed/motif_stack.py", "nn/signed/sigat.py", "nn/signed/sdgnn.py")


# DiGCL, the logistic probes, the real-data loaders and the experiments
# that read them
REAL_DATA_MODULES = (
    "utils/general/logistic.py", "utils/general/evaluation.py",
    "utils/directed/digcl_utils.py", "nn/directed/digcl.py",
    "data/load_real.py", "data/schema_files.py",
    "experiments/digcl_node.py", "experiments/digcl_link.py",
    "experiments/_directed_node.py", "experiments/dgcn_node.py",
    "experiments/digcn_node.py", "experiments/digcn_inception_node.py",
    "experiments/_signed_embedding.py",
    "experiments/run_link_sign_prediction.py",
    "experiments/run_link_sign_direction_tasks.py")


# the multi-device layer
PARALLEL_MODULES = (
    "parallel/mesh.py", "parallel/distributed.py", "parallel/mxu_shard.py",
    "parallel/sharded.py", "parallel/edge_spmm.py", "parallel/attn_shard.py")


@pytest.mark.parametrize("module", SIGNED_MODULES + ATTENTION_MODULES
                         + REAL_DATA_MODULES + PARALLEL_MODULES)
def test_signed_modules_import_nothing_forbidden(module):
    path = PORT / module
    assert path.is_file()
    assert [m for m in _imports(path) if _forbidden(m)] == []



# The direction of the port's imports, bottom to top: device and
# instrument, native, ops, graph and spectral, nn and utils, parallel,
# train, experiments.  The layers below parallel/ and train/ import
# neither, at module level or inside a function.
PKG = "pytorch_geometric_signed_directed_tpu_torch"
LOWER = ("ops", "spectral", "nn", "utils", "data", "native", "graph.py")
UPPER = (PKG + ".train", PKG + ".parallel")


def _resolved_imports(source: str, module: str, is_package: bool = False):
    """Every module an import statement of ``source`` (the module
    ``module``) names, relative imports resolved and imports inside
    functions included; ``from a import b`` names ``a`` and ``a.b``."""
    package = module.split(".") if is_package else module.split(".")[:-1]
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                up = package[:len(package) - node.level + 1]
                base = ".".join(up + ([node.module] if node.module else []))
            yield base
            yield from (base + "." + alias.name for alias in node.names)


def _module_name(path: pathlib.Path):
    rel = path.relative_to(ROOT).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        return ".".join(parts[:-1]), True
    return ".".join(parts), False


def _upper(name: str) -> bool:
    return any(name == u or name.startswith(u + ".") for u in UPPER)


def test_the_import_resolver_sees_function_level_and_relative_imports():
    src = ("from ...train.profiling import span\n"
           "def f():\n"
           "    from ...parallel.mxu_shard import sharded_mxu_spmm\n"
           "    from ... import parallel\n"
           "    from . import build\n")
    got = set(_resolved_imports(src, PKG + ".ops.cuda.scatter_csr"))
    assert {PKG + ".train.profiling", PKG + ".parallel.mxu_shard",
            PKG + ".parallel", PKG + ".ops.cuda.build"} <= got
    got = set(_resolved_imports("from . import scatter_csr\n",
                                PKG + ".ops.cuda", is_package=True))
    assert PKG + ".ops.cuda.scatter_csr" in got
    assert _upper(PKG + ".train.profiling") and _upper(PKG + ".parallel")
    assert not _upper(PKG + ".training") and not _upper(PKG + ".ops")


def test_the_lower_layers_import_neither_train_nor_parallel():
    files = [p for top in LOWER for p in (
        [PORT / top] if top.endswith(".py")
        else sorted((PORT / top).rglob("*.py")))]
    assert len(files) > 60
    bad = []
    for path in files:
        module, is_package = _module_name(path)
        bad += [(str(path.relative_to(ROOT)), m) for m in _resolved_imports(
            path.read_text(), module, is_package) if _upper(m)]
    assert bad == []


def test_instrument_imports_nothing_of_the_package():
    path = PORT / "instrument.py"
    module, _ = _module_name(path)
    got = set(_resolved_imports(path.read_text(), module))
    assert got and not [m for m in got if m.startswith(PKG)]


def _import_nesting(stderr: str):
    """(module, the modules whose import it ran inside, innermost first)
    for each line of ``python -X importtime``'s report, which lists a
    module after the modules its import loaded, two spaces deeper."""
    entries = []
    for line in stderr.splitlines():
        if not line.startswith("import time:") or line.count("|") < 2:
            continue
        field = line.split("|", 2)[2]
        name = field.strip()
        if name != "imported package":
            entries.append((len(field) - len(field.lstrip(" ")), name))
    out = []
    for i, (depth, name) in enumerate(entries):
        outer = []
        for d, n in entries[i + 1:]:
            if d < depth:
                outer.append(n)
                depth = d
        out.append((name, outer))
    return out


def test_train_loads_only_where_the_package_root_imports_it():
    """In a fresh interpreter, no module of train/ loads inside the import
    of ops/, spectral/ or nn/: train/ loads where the package root
    imports it, after them."""
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-c", f"import {PKG}"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-2000:]
    nesting = _import_nesting(proc.stderr)
    order = [name for name, _ in nesting]
    lower = tuple(f"{PKG}.{m}" for m in ("ops", "spectral", "nn"))
    inside = [(name, outer) for name, outer in nesting
              if name.startswith(PKG + ".train")
              and any(o == m or o.startswith(m + ".")
                      for o in outer for m in lower)]
    assert inside == []
    assert dict(nesting)[PKG + ".train"] == [PKG]
    assert all(order.index(PKG + ".train") > order.index(m) for m in lower)

JAX = ROOT / "pytorch_geometric_signed_directed_tpu"
# JAX module names the port deliberately does without, with the reason
NOT_PORTED = {
    # the port's SNEAConv, GATConv and motif layers take aggregate= per
    # model, where the JAX package switches a module global
    ("nn/signed/snea_conv.py", "AGGREGATE_BACKEND"),
}


def _top_level_names(path: pathlib.Path, bound_by_imports: bool):
    """Public names a module defines at top level (functions, classes,
    assignments), and with ``bound_by_imports`` those its imports bind."""
    names = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else \
                [node.target]
            names.update(n.id for t in targets for n in ast.walk(t)
                         if isinstance(n, ast.Name))
        elif bound_by_imports and isinstance(node, (ast.Import,
                                                    ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return {n for n in names if not n.startswith("_")}


JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py")
                     if p.relative_to(JAX).parts[:2] != ("ops", "pallas"))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_port_module_has_the_jax_modules_public_names(module):
    """Each module of the JAX package (its Pallas kernels aside) has a
    counterpart file in the port whose top-level names (defined or
    imported) hold every public name the JAX module defines."""
    port = PORT / module
    assert port.is_file(), f"no counterpart of {module}"
    want = _top_level_names(JAX / module, bound_by_imports=False)
    have = _top_level_names(port, bound_by_imports=True)
    missing = {n for n in want - have if (module, n) not in NOT_PORTED}
    assert missing == set()


def test_the_port_scripts_import_nothing_forbidden():
    for script in ("giant_digrac_torch.py", "dryrun_multiprocess_torch.py",
                   "profile_torch_magnet_step.py", "span_report_torch.py"):
        path = ROOT / "scripts" / script
        assert [m for m in _imports(path) if _forbidden(m)] == [], script


def test_sssnet_and_sgcn_run_with_jax_and_sklearn_blocked():
    """In a fresh interpreter that cannot import JAX, flax, scikit-learn or
    the JAX package: the sssnet experiment and an SGCN loss on the CPU."""
    code = f"""
import sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None      # import raises, find_spec gives None
import numpy as np
from pytorch_geometric_signed_directed_tpu_torch.experiments import sssnet
from pytorch_geometric_signed_directed_tpu_torch.nn.signed import sgcn
sssnet.main(["--N", "120", "--epochs", "2", "--device", "cpu"])
rng = np.random.default_rng(0)
es = np.column_stack([rng.integers(0, 50, 300), rng.integers(0, 50, 300),
                      np.where(rng.random(300) < 0.7, 1, -1)])
pos, neg, emb, P, Q = sgcn.prepare_sgcn_inputs(50, es, in_dim=8,
                                               device="cpu")
from pytorch_geometric_signed_directed_tpu_torch.utils import (
    negative_sampling, structured_negative_sampling)
m = sgcn.SGCN(50, in_dim=8, out_dim=8, init_emb=emb, device="cpu")
none = negative_sampling(np.concatenate([pos, neg], 1), 50)
loss = m.loss(P, Q, pos, neg, none, structured_negative_sampling(pos, 50),
              structured_negative_sampling(neg, 50))
loss.backward()
assert not any(k.split(".")[0] in {FORBIDDEN!r} and m is not None
               for k, m in sys.modules.items())
print("ok", float(loss))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    assert "mean ARI" in proc.stdout and "ok" in proc.stdout


def test_snea_and_sigat_run_with_jax_and_sklearn_blocked():
    """In a fresh interpreter that cannot import JAX, flax, scikit-learn or
    the JAX package: an SNEA loss (spectral embedding, K1 aggregates) and
    a SiGAT loss on the motif stack, on the CPU."""
    code = f"""
import sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None      # import raises, find_spec gives None
import numpy as np
from pytorch_geometric_signed_directed_tpu_torch.nn import SNEA, SiGAT
from pytorch_geometric_signed_directed_tpu_torch.nn.signed import (
    prepare_sigat_inputs, prepare_snea_inputs)
from pytorch_geometric_signed_directed_tpu_torch.utils import (
    negative_sampling, structured_negative_sampling)
rng = np.random.default_rng(0)
es = np.column_stack([rng.integers(0, 50, 300), rng.integers(0, 50, 300),
                      np.where(rng.random(300) < 0.7, 1, -1)])
pos, neg, emb, graphs = prepare_snea_inputs(50, es, in_dim=8, device="cpu")
m = SNEA(50, in_dim=8, out_dim=8, init_emb=emb, device="cpu")
none = negative_sampling(np.concatenate([pos, neg], 1), 50)
loss = m.loss(graphs, pos, neg, none, structured_negative_sampling(pos, 50),
              structured_negative_sampling(neg, 50))
loss.backward()
pos, neg, emb, stack = prepare_sigat_inputs(50, es, in_dim=8, fused=True,
                                            device="cpu")
s = SiGAT(50, in_dim=8, out_dim=8, init_emb=emb, fused=True, device="cpu")
s.loss(stack, pos, neg).backward()
assert not any(k.split(".")[0] in {FORBIDDEN!r} and m is not None
               for k, m in sys.modules.items())
print("ok", float(loss))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    assert "ok" in proc.stdout


def test_digcl_and_the_real_data_path_run_with_jax_and_sklearn_blocked(
        tmp_path):
    """In a fresh interpreter that cannot import JAX, flax, scikit-learn or
    the JAX package: digcl_node on cora_ml's schema (the numpy one-vs-rest
    grid probes it), link_sign_prediction on bitcoin_alpha's (the numpy
    lbfgs probe and metrics) and the sign/direction tasks with SGCN."""
    code = f"""
import sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None      # import raises, find_spec gives None
import os
from pytorch_geometric_signed_directed_tpu_torch.data import schema_files
schema_files.write_citation(".", "cora_ml", num_nodes=560, num_edges=1500,
                            num_classes=2, num_features=12)
schema_files.write_signed_csv(".", num_nodes=80, num_pos=300, num_neg=60)
os.environ["PGSD_TPU_NO_CACHE"] = "1"
from pytorch_geometric_signed_directed_tpu_torch.experiments import (
    run, run_link_sign_direction_tasks)
run("digcl_node", ["--epochs", "2", "--splits", "1", "--device", "cpu"])
run("link_sign_prediction", ["--epochs", "2", "--device", "cpu"])
run_link_sign_direction_tasks.main(["--method", "sgcn", "--epochs", "2",
                                    "--runs", "1", "--device", "cpu"])
assert not any(k.split(".")[0] in {FORBIDDEN!r} and m is not None
               for k, m in sys.modules.items())
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr
    assert "DiGCL (log): acc" in proc.stdout
    assert "auc" in proc.stdout and "sgcn four_class" in proc.stdout


_SCHEMA = None


def _schema_dir() -> str:
    """Tiny files in the schema of each dataset the real-data entry points
    read by default, written once a process."""
    global _SCHEMA
    if _SCHEMA is None:
        from pytorch_geometric_signed_directed_tpu_torch.data import (
            schema_files)

        _SCHEMA = tempfile.TemporaryDirectory()
        r = _SCHEMA.name
        schema_files.write_citation(r, "cora_ml", num_nodes=600,
                                    num_edges=900, num_classes=2,
                                    num_features=6)
        schema_files.write_telegram(r, num_nodes=30, num_edges=150,
                                    num_classes=2)
        schema_files.write_signed_csv(r, num_nodes=40, num_pos=120,
                                      num_neg=30)
    return _SCHEMA.name


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
    from pytorch_geometric_signed_directed_tpu_torch.nn import (
        SGCN, SGCNConv, SIMPA, SSSNET_link_prediction,
        SSSNET_node_clustering)
    from pytorch_geometric_signed_directed_tpu_torch.nn.signed import sgcn
    from pytorch_geometric_signed_directed_tpu_torch.nn.signed import (
        SDGNN, SNEA, GATConv, MotifGATStack, SDRLayer, SiGAT, SNEAConv,
        build_attention_graph, build_motif_stack, gat_graph,
        prepare_sdgnn_inputs, prepare_sigat_inputs, prepare_snea_inputs,
        snea_graphs)
    from pytorch_geometric_signed_directed_tpu_torch.ops import (
        build_coo, build_scatter_plan, coo_from_scipy, dual_propagator,
        make_propagator)
    from pytorch_geometric_signed_directed_tpu_torch.utils import (
        Link_Sign_Entropy_Loss, Prob_Balanced_Normalized_Loss,
        Prob_Balanced_Ratio_Loss, Unhappy_Ratio)
    from pytorch_geometric_signed_directed_tpu_torch.utils.signed import (
        Sign_Direction_Loss, Sign_Triangle_Loss)
    import scipy.sparse as sp
    from pytorch_geometric_signed_directed_tpu_torch.parallel import (
        local_mesh, make_mesh)
    from pytorch_geometric_signed_directed_tpu_torch.spectral import (
        magnet_operator_arrays, magnet_propagators, magnetic_pair,
        magnetic_template)
    from pytorch_geometric_signed_directed_tpu_torch.train import Trainer
    from pytorch_geometric_signed_directed_tpu_torch.nn import DiGCL
    from pytorch_geometric_signed_directed_tpu_torch.nn.directed import (
        DiGCL_Encoder)
    from pytorch_geometric_signed_directed_tpu_torch.experiments import (
        run_link_sign_direction_tasks)

    ei = np.array([[0, 1, 2], [1, 2, 0]])
    one = np.ones(3)
    A_p = sp.csr_matrix((one, (ei[0], ei[1])), shape=(3, 3))
    A_n = sp.csr_matrix((one[:1], (ei[1][:1], ei[0][:1])), shape=(3, 3))
    signed = np.array([[0, 1, 1], [1, 2, -1], [2, 0, 1]])
    emb = np.ones((3, 4), np.float32)

    def experiment(name, *argv):
        def go(device=None):
            dev = [] if device is None else ["--device", device]
            return run(name, [*argv, "--epochs", "1", *dev])
        return go

    synthetic = ("--dataset", "synthetic", "--num_nodes", "40")

    def real(name, *argv, main=None):
        """An experiment on the schema files of ``_schema_dir``, found
        through $PGSD_TPU_DATA."""
        def go(device=None):
            dev = [] if device is None else ["--device", device]
            env = {"PGSD_TPU_DATA": _schema_dir(), "PGSD_TPU_NO_CACHE": "1"}
            with mock.patch.dict(os.environ, env):
                if main is not None:
                    return main([*argv, "--epochs", "1", *dev])
                return run(name, [*argv, "--epochs", "1", *dev])
        return go

    return {
        "magnet_propagators": lambda **kw: magnet_propagators(ei, **kw),
        "magnetic_template": lambda **kw: magnetic_template(ei, **kw),
        "make_mesh": lambda **kw: make_mesh(**kw),
        "local_mesh": lambda **kw: local_mesh(**kw),
        "make_mesh(shape=(2, 2))": lambda **kw: make_mesh(
            shape=(2, 2), axis_names=("data", "graph"), **kw),
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
        "experiment sssnet": experiment("sssnet", "--N", "60"),
        "coo_from_scipy": lambda **kw: coo_from_scipy(A_p, **kw),
        "mean_propagator": lambda **kw: graph.mean_propagator(ei, **kw),
        "sgcn_dual_propagator": lambda **kw: sgcn.sgcn_dual_propagator(
            ei, ei[[1, 0]], 3, mode="segment", **kw),
        "prepare_sgcn_inputs": lambda **kw: sgcn.prepare_sgcn_inputs(
            3, signed, in_dim=4, init_emb=emb, **kw),
        "Prob_Balanced_Normalized_Loss":
            lambda **kw: Prob_Balanced_Normalized_Loss(A_p, A_n, **kw),
        "Prob_Balanced_Ratio_Loss":
            lambda **kw: Prob_Balanced_Ratio_Loss(A_p, A_n, **kw),
        "Unhappy_Ratio": lambda **kw: Unhappy_Ratio(A_p, A_n, **kw),
        "Link_Sign_Entropy_Loss": lambda **kw: Link_Sign_Entropy_Loss(
            4, **kw),
        "Sign_Triangle_Loss": lambda **kw: Sign_Triangle_Loss(4, **kw),
        "Sign_Direction_Loss": lambda **kw: Sign_Direction_Loss(4, **kw),
        "SIMPA": lambda **kw: SIMPA(2, **kw),
        "SSSNET_node_clustering":
            lambda **kw: SSSNET_node_clustering(2, 4, 3, **kw),
        "SSSNET_link_prediction":
            lambda **kw: SSSNET_link_prediction(2, 4, 3, **kw),
        "SGCNConv": lambda **kw: SGCNConv(2, 4, True, **kw),
        "SGCN": lambda **kw: SGCN(3, in_dim=4, out_dim=4, init_emb=emb,
                                  **kw),
        "build_scatter_plan": lambda **kw: build_scatter_plan(
            np.array([0, 0, 2]), 3, **kw),
        "build_attention_graph": lambda **kw: build_attention_graph(
            [(ei, 0, True)], 3, **kw),
        "snea_graphs": lambda **kw: snea_graphs(ei, ei[[1, 0]], 3, **kw),
        "gat_graph": lambda **kw: gat_graph(ei, 3, **kw),
        "build_motif_stack": lambda **kw: build_motif_stack([ei, ei], 3,
                                                            **kw),
        "prepare_snea_inputs": lambda **kw: prepare_snea_inputs(
            3, signed, init_emb=emb, **kw),
        "prepare_sigat_inputs": lambda **kw: prepare_sigat_inputs(
            3, signed, init_emb=emb, **kw),
        "prepare_sdgnn_inputs": lambda **kw: prepare_sdgnn_inputs(
            3, signed, init_emb=emb, **kw),
        "SNEAConv": lambda **kw: SNEAConv(2, 4, True, **kw),
        "SNEA": lambda **kw: SNEA(3, in_dim=4, out_dim=4, init_emb=emb, **kw),
        "GATConv": lambda **kw: GATConv(2, 4, **kw),
        "MotifGATStack": lambda **kw: MotifGATStack(2, 4, 3, **kw),
        "SiGAT": lambda **kw: SiGAT(3, in_dim=4, out_dim=4, init_emb=emb,
                                    **kw),
        "SDRLayer": lambda **kw: SDRLayer(2, 4, **kw),
        "SDGNN": lambda **kw: SDGNN(3, in_dim=4, out_dim=4, init_emb=emb,
                                    **kw),
        "DiGCL": lambda **kw: DiGCL(2, "relu", 4, 3, 0.5, 2, **kw),
        "DiGCL_Encoder": lambda **kw: DiGCL_Encoder(2, 4, **kw),
        "experiment digcl_node": real("digcl_node", "--splits", "1"),
        "experiment digcl_link": real("digcl_link", "--dataset", "telegram",
                                      "--splits", "1"),
        "experiment dgcn_node": real("dgcn_node"),
        "experiment digcn_node": real("digcn_node"),
        "experiment digcn_inception_node": real("digcn_inception_node"),
        "experiment link_sign_prediction": real("link_sign_prediction"),
        "experiment magnet_node (telegram)": real("magnet_node"),
        "run_link_sign_direction_tasks": real(
            None, "--method", "sgcn", "--runs", "1",
            main=run_link_sign_direction_tasks.main),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_the_card(name, monkeypatch):
    make = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    assert make(device="cpu") is not None
