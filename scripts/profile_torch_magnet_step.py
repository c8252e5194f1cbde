#!/usr/bin/env python3
"""Where the time of one MagNet training step goes, on the card.

Builds the bench's magnet_mxu configuration with the PyTorch/CUDA port
(DSBM N=65,536, seed 0; MagNet K=2, hidden 32, 2 layers; Adam lr 1e-2),
with ``--giant`` chip_smoke.py's giant graph (the giant bench's
power-law digraph, N=2,400,000, on the column-split and streamed layouts,
bf16 messages and "default" matmul precision as the bench runs it), or
with ``--bsr`` the bench's headline graph (DSBM N=8192, average degree 24)
on the ``bsr`` tier, or with ``--trainable-q`` the magnet_mxu graph with
trainable q from 0.25 on a flat mxu template (``--sharded``: on the
one-card sharded template, ``local_mesh()``), or with ``--experiment
NAME`` the training step of that experiment (magnet_node, magnet_link,
msgnn_node, msgnn_link) at its default widths on ``--dataset synthetic
--num_nodes N`` (9000 by default; magnet_link's first split); times
steps with CUDA events, then traces a window of steps with torch.profiler
and prints device time by kernel, each of the port's kernels named by the
wrapper that launches it, and the device's busy share of the window.

Run from the root of the checkout:

    python3 scripts/profile_torch_magnet_step.py [--steps 20]
        [--giant | --bsr | --trainable-q [--sharded]
         | --experiment NAME [--num_nodes N]]
"""
import argparse
import importlib
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from pytorch_geometric_signed_directed_tpu_torch.data import DSBM  # noqa: E402
from pytorch_geometric_signed_directed_tpu_torch.graph import in_out_degree  # noqa: E402
from pytorch_geometric_signed_directed_tpu_torch.nn import (  # noqa: E402
    MagNet_node_classification)
from pytorch_geometric_signed_directed_tpu_torch.ops import spmm  # noqa: E402
from pytorch_geometric_signed_directed_tpu_torch.parallel import (  # noqa: E402
    local_mesh, shard_magnet_laplacian)
from pytorch_geometric_signed_directed_tpu_torch.spectral import (  # noqa: E402
    magnet_propagators, magnetic_template)
from pytorch_geometric_signed_directed_tpu_torch.train import Trainer  # noqa: E402
from pytorch_geometric_signed_directed_tpu_torch.utils import (  # noqa: E402
    meta_graph_generation)


# substrings of the port's device kernel names -> the wrapper (and TPU
# kernel) they belong to; the first match wins
PORT_KERNELS = (
    ("csr_dual_sddmm_kernel", "csr_dual_sddmm (K3/K4)"),
    ("PairSource", "csr_pair_spmm (K1/K2)"),
    ("DualSource", "csr_dual_spmm (K1/K2)"),
    ("csr_msgs_kernel", "csr_scatter_sum (K1/K2)"),
    ("csr_span_kernel", "csr_scatter_sum (K1/K2)"),
    ("csr_walk_kernel", "csr_scatter_sum (K1/K2)"),
    ("reduce_partials_kernel", "csr_dual_sddmm dq sum (K3/K4)"),
    ("combine_pieces_kernel", "cut-row combine (K1-K4)"),
    ("bsr_", "bsr_spmm (K5)"),
)


def label(name: str) -> str:
    for key, wrapper in PORT_KERNELS:
        if key in name:
            return f"[{wrapper}] {name}"
    return name


def dsbm_setup(n, avg_deg, mode, template=False):
    F = meta_graph_generation("cyclic", 5, 0.05, False)
    A, labels = DSBM(n, 5, avg_deg / n * 5 / 2, F,
                     rng=np.random.default_rng(0))
    ei = np.vstack(A.nonzero())
    w = A.tocoo().data
    x = in_out_degree(ei, n, edge_weight=w)
    x = torch.from_numpy((x / max(x.max(), 1.0)).astype(np.float32)).cuda()
    y = torch.from_numpy(labels).cuda()
    if template:
        return ei.shape[1], x, y, magnetic_template(ei, w, num_nodes=n,
                                                    mode=mode)
    return ei.shape[1], x, y, magnet_propagators(ei, w, q=0.25, num_nodes=n,
                                                 mode=mode)


def giant_setup():
    g = chip_smoke.GIANT
    n = g["nodes"]
    row, col = chip_smoke.powerlaw_digraph(n, g["edges"], g["alpha"],
                                           seed=g["seed"])
    ei = np.vstack([row, col])
    w = np.ones(len(row), np.float32)
    x = in_out_degree(ei, n, edge_weight=w)
    x = torch.from_numpy((x / max(x.max(), 1.0)).astype(np.float32)).cuda()
    y = torch.from_numpy(np.random.default_rng(1).choice(
        5, n, p=chip_smoke.LABEL_FREQ)).cuda()
    lap = magnet_propagators(ei, w, q=0.25, num_nodes=n, mode="mxu")
    return len(row), x, y, lap


def experiment_setup(name, num_nodes):
    """(input edges, Laplacian pair, (trainer, state, batch)) of one
    training step of experiment ``name``, as its ``train_split`` makes
    it."""
    mod = importlib.import_module(
        f"pytorch_geometric_signed_directed_tpu_torch.experiments.{name}")
    args = mod.parser().parse_args(["--dataset", "synthetic", "--num_nodes",
                                    str(num_nodes), "--device", "cuda"])
    inputs = mod.build_inputs(args, "cuda")
    print(f"host seconds: {inputs.seconds}")
    if name == "magnet_link":
        s = mod.split_inputs(args, inputs, 0)
        print(f"split host seconds: {s.seconds}")
        return s.graph_edges, s.lap, mod.make_trainer(
            args, s, mod.make_model(args, inputs))
    if name == "msgnn_link":
        return inputs.graph_edges, inputs.lap, mod.make_trainer(
            args, inputs, mod.make_model(args, inputs))
    return inputs.num_edges, inputs.lap, mod.make_trainer(
        args, inputs, 0, mod.make_model(args, inputs, 0))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--giant", action="store_true",
                       help="the giant graph on the split and streamed "
                            "layouts")
    which.add_argument("--bsr", action="store_true",
                       help="the N=8192 graph on the bsr tier")
    which.add_argument("--trainable-q", action="store_true",
                       help="trainable q on the magnet_mxu graph's template")
    which.add_argument("--experiment",
                       choices=("magnet_node", "magnet_link", "msgnn_node",
                                "msgnn_link"),
                       help="an experiment's training step")
    ap.add_argument("--sharded", action="store_true",
                    help="with --trainable-q: the one-card sharded template")
    ap.add_argument("--num_nodes", type=int, default=9000,
                    help="with --experiment: the synthetic graph's nodes")
    args = ap.parse_args()
    if args.sharded and not args.trainable_q:
        ap.error("--sharded goes with --trainable-q")
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")

    step = None
    if args.experiment:
        e, lap, step = experiment_setup(args.experiment, args.num_nodes)
    elif args.giant:
        e, x, y, lap = giant_setup()
        spmm.set_message_dtype("bf16")
        spmm.set_matmul_precision("default")
    elif args.bsr:
        e, x, y, lap = dsbm_setup(8192, 24, "bsr")
    elif args.trainable_q:
        e, x, y, lap = dsbm_setup(65_536, 30, "auto", template=True)
        if args.sharded:
            lap = shard_magnet_laplacian(lap, local_mesh())
    else:
        e, x, y, lap = dsbm_setup(65_536, 30, "auto")
    if args.trainable_q:
        print(f"template: {lap.mode}")
    else:
        D = lap.dual
        for name, d in (("forward", D), ("transposed", D and D.transposed)):
            print(f"{name} layout: "
                  + ("two single bsr operators" if d is None
                     else f"{len(d.blocks)} blocks ({d.hot_blocks} hot)"
                     if d.blocks else "flat"))
    if step is None:
        model = MagNet_node_classification(
            num_features=2, hidden=32, K=2, label_dim=5, activation=True,
            layer=2, trainable_q=args.trainable_q, q=0.25,
            generator=torch.Generator().manual_seed(0))
        trainer = Trainer(
            lambda m: torch.nn.functional.nll_loss(m(x, x, lap), y), lr=1e-2)
        step = trainer, trainer.init(model), ()
    trainer, state, batch = step

    for _ in range(5):                     # warm-up: cuBLAS, Adam state
        trainer.step_async(state, *batch)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(args.steps + 1)]
    ev[0].record()
    for i in range(args.steps):
        trainer.step_async(state, *batch)
        ev[i + 1].record()
    torch.cuda.synchronize()
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(args.steps)]
    med = statistics.median(step_ms)
    print(f"step: median {med:.4f} ms, min {min(step_ms):.4f} ms, "
          f"max {max(step_ms):.4f} ms over {args.steps} steps "
          f"({e / (med / 1e3):.1f} input edges/s)")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        a.record()
        for _ in range(args.steps):
            trainer.step_async(state, *batch)
        b.record()
        torch.cuda.synchronize()
    window_ms = a.elapsed_time(b)
    # device-side work only: user annotations (e.g. "Optimizer.step")
    # also appear on the device timeline and overlap their kernels
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        sys.exit("the trace holds no device kernels: time with CUDA events "
                 "only (see the step line above)")
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    per_step = busy_ms / args.steps
    print(f"traced window: {window_ms:.3f} ms for {args.steps} steps with "
          f"the profiler on; {len(kernels) / args.steps:.1f} device "
          f"kernels and {per_step:.4f} ms of device time per step")
    print(f"busy share of an untraced step: {per_step / med:.3f} "
          f"(idle share {1 - per_step / med:.3f}) = device ms per step / "
          f"median step ms")
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    print("device ms per step by kernel (largest first):")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        if t / args.steps < 0.005:
            continue
        print(f"  {t / args.steps:8.4f} ms  {c / args.steps:5.1f}x  "
              f"{label(name)[:140]}")


if __name__ == "__main__":
    main()
