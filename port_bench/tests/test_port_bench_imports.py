"""Nothing under port_bench/ imports JAX or the JAX package, and the
plain references import nothing of the port.  Module names are compared
by their whole top-level name: the port's name begins with the JAX
package's."""
import ast
import os
import subprocess
import sys

from conftest import ROOT

BENCH = os.path.join(ROOT, "port_bench")
FORBIDDEN = {"jax", "jaxlib", "flax", "pytorch_geometric_signed_directed_tpu"}
PORT = "pytorch_geometric_signed_directed_tpu_torch"


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    found = [(p, m) for p in sources() for m in imported(p)
             if m.split(".")[0] in FORBIDDEN]
    assert not found
    assert len(list(sources())) > 20


def test_the_references_import_nothing_of_the_port():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for m in imported(os.path.join(ref, f)):
                top = m.split(".")[0]
                assert top != PORT, (f, m)
                assert not m.startswith("port_bench.drivers"), (f, m)
                assert top in {"port_bench", "math", "warnings", "typing",
                               "numpy", "scipy", "torch"}, (f, m)


def test_a_cpu_run_loads_no_jax():
    """A cell run end to end on the CPU in a fresh interpreter where JAX,
    flax and the JAX package cannot be imported."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', "
        "'pytorch_geometric_signed_directed_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import time\n"
        "from port_bench import harness\n"
        "cell = harness.Cell.find(harness.ROOT, 'digrac.giant_powerlaw')\n"
        "cell.traffic.update(nodes=9000, draws=20000)\n"
        "r, _, _ = harness.run_cell(cell, 7, 0.1, False, 'cpu', "
        "time.perf_counter())\n"
        "assert r['correct'], r['check']\n"
        "print([m for m in sys.modules if m.split('.')[0] in "
        "harness.FORBIDDEN and sys.modules[m] is not None])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
