"""Host seconds of the port's native tier against its numpy branch.

Builds two graphs: the giant bench's power-law digraph (N=2,400,000,
10M draws, alpha 1.0, seed 0; ``chip_smoke.powerlaw_digraph``) and the
magnet_node experiment's synthetic DSBM at ``--num_nodes 9000`` (seed 0).
On each it times, in turns (numpy, native, native, numpy, ...), the
sym-normalized magnetic Laplacian at q=0.25 (``magnetic_laplacian``) and
the coalescing of the input edge list (``coalesce_edges``), each once
through the native tier (the thresholds as they are) and once through the
numpy branch (every native threshold raised past the input), and prints
the seconds and how far the two results differ.

Run from the root of the checkout:

    python3 scripts/time_native_tier.py [--repeats 2] [--skip-giant]
"""
import argparse
import contextlib
import os
import platform
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402


@contextlib.contextmanager
def numpy_branch():
    """Every native threshold of the port past any input."""
    from pytorch_geometric_signed_directed_tpu_torch import native
    from pytorch_geometric_signed_directed_tpu_torch.ops import coalesce
    from pytorch_geometric_signed_directed_tpu_torch.spectral import magnetic

    knobs = ((magnetic, "NATIVE_MIN_EDGES"), (coalesce, "FUSED_COALESCE_MIN"),
             (native, "ARGSORT_MIN"))
    saved = [getattr(m, k) for m, k in knobs]
    for m, k in knobs:
        setattr(m, k, 1 << 62)
    try:
        yield
    finally:
        for (m, k), v in zip(knobs, saved):
            setattr(m, k, v)


def graphs(skip_giant):
    from chip_smoke import GIANT, powerlaw_digraph
    from pytorch_geometric_signed_directed_tpu_torch.data import DSBM
    from pytorch_geometric_signed_directed_tpu_torch.utils import (
        meta_graph_generation)

    F = meta_graph_generation("cyclic", 5, 0.05, False)
    A, _ = DSBM(9000, 5, 0.3, F, rng=np.random.default_rng(0))
    A = A.tocoo()
    yield "magnet_node N=9000", np.stack([A.row, A.col]).astype(np.int64), \
        9000
    if not skip_giant:
        row, col = powerlaw_digraph(GIANT["nodes"], GIANT["edges"],
                                    GIANT["alpha"], GIANT["seed"])
        yield f"giant N={GIANT['nodes']}", np.stack([row, col]), \
            GIANT["nodes"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--skip-giant", action="store_true")
    args = ap.parse_args()

    from pytorch_geometric_signed_directed_tpu_torch import native
    from pytorch_geometric_signed_directed_tpu_torch.ops.coalesce import (
        coalesce_edges)
    from pytorch_geometric_signed_directed_tpu_torch.spectral import (
        magnetic_laplacian)

    t0 = time.perf_counter()
    native.build()
    print(f"python {platform.python_version()}, numpy {np.__version__}, "
          f"{os.cpu_count()} cores, {platform.node()}; native build "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for label, ei, n in graphs(args.skip_giant):
        w = np.ones(ei.shape[1])
        jobs = {
            "laplacian": lambda: magnetic_laplacian(ei, w, num_nodes=n,
                                                    q=0.25),
            "coalesce": lambda: coalesce_edges(ei[0], ei[1], w,
                                               num_cols=n)}
        for job, fn in jobs.items():
            secs = {"numpy": [], "native": []}
            out = {}
            for i in range(args.repeats):
                order = ("numpy", "native") if i % 2 == 0 else \
                    ("native", "numpy")
                for branch in order:
                    ctx = numpy_branch() if branch == "numpy" else \
                        contextlib.nullcontext()
                    with ctx:
                        t = time.perf_counter()
                        out[branch] = fn()
                        secs[branch].append(time.perf_counter() - t)
            a, b = out["native"], out["numpy"]
            idx_equal = all(np.array_equal(x, y) for x, y in
                            zip(a, b) if x.dtype.kind == "i")
            diff = max(float(np.abs(x - y).max(initial=0.0))
                       for x, y in zip(a, b) if x.dtype.kind == "f")
            print(f"{label}, {ei.shape[1]} input edges, {job} "
                  f"({len(a[-1])} entries): native "
                  f"{[round(s, 3) for s in secs['native']]} s, numpy "
                  f"{[round(s, 3) for s in secs['numpy']]} s; indices equal "
                  f"{idx_equal}, largest value difference {diff:.3g}",
                  flush=True)


if __name__ == "__main__":
    main()
