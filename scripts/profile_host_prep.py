"""Host preparation of the PyTorch port's experiments, stage by stage.

Runs each named experiment's ``build_inputs`` (graph, splits, features,
the Laplacian and its layout on ``--device``) at ``--dataset synthetic
--num_nodes N`` under cProfile, and prints the seconds of each stage and
the functions that took the most time of their own.

Run from the root of the checkout:

    python3 scripts/profile_host_prep.py [--num_nodes 9000] [--top 12]
        [--device cuda] [magnet_node magnet_link msgnn_node msgnn_link]
"""
import argparse
import cProfile
import importlib
import os
import platform
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

NAMES = ("magnet_node", "magnet_link", "msgnn_node", "msgnn_link")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", choices=NAMES, default=list(NAMES))
    ap.add_argument("--num_nodes", type=int, default=9000)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import numpy as np
    import scipy

    print(f"python {platform.python_version()}, numpy {np.__version__}, "
          f"scipy {scipy.__version__}, {os.cpu_count()} cores")
    for name in args.names:
        mod = importlib.import_module(
            f"pytorch_geometric_signed_directed_tpu_torch.experiments.{name}")
        argv = ["--dataset", "synthetic", "--num_nodes", str(args.num_nodes),
                "--device", args.device]
        if name == "magnet_link":
            argv += ["--splits", "1"]
        exp_args = mod.parser().parse_args(argv)
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        inputs = mod.build_inputs(exp_args, args.device)
        prof.disable()
        total = time.perf_counter() - t0
        stages = ", ".join(f"{k} {v:.2f}" for k, v in inputs.seconds.items())
        print(f"{name}: N={args.num_nodes} input edges {inputs.num_edges}: "
              f"{total:.2f} s ({stages})", flush=True)
        pstats.Stats(prof).sort_stats("tottime").print_stats(args.top)
        del inputs


if __name__ == "__main__":
    main()
