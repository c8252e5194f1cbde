#!/usr/bin/env python3
"""Where the time of one MagNet training step goes, on the card.

Builds the bench's magnet_mxu configuration with the PyTorch/CUDA port
(DSBM N=65,536, seed 0; MagNet K=2, hidden 32, 2 layers; Adam lr 1e-2),
times steps with CUDA events, then traces a window of steps with
torch.profiler and prints device time by kernel and the device's busy
share of the window.

Run from the root of the checkout:

    python3 scripts/profile_torch_magnet_step.py [--steps 20]
"""
import argparse
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pytorch_geometric_signed_directed_tpu_torch.data import DSBM  # noqa: E402
from pytorch_geometric_signed_directed_tpu_torch.graph import in_out_degree  # noqa: E402
from pytorch_geometric_signed_directed_tpu_torch.nn import (  # noqa: E402
    MagNet_node_classification)
from pytorch_geometric_signed_directed_tpu_torch.spectral import (  # noqa: E402
    magnet_propagators)
from pytorch_geometric_signed_directed_tpu_torch.train import Trainer  # noqa: E402
from pytorch_geometric_signed_directed_tpu_torch.utils import (  # noqa: E402
    meta_graph_generation)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")

    n = 65_536
    F = meta_graph_generation("cyclic", 5, 0.05, False)
    A, labels = DSBM(n, 5, 30 / n * 5 / 2, F, rng=np.random.default_rng(0))
    ei = np.vstack(A.nonzero())
    w = A.tocoo().data
    x = in_out_degree(ei, n, edge_weight=w)
    x = torch.from_numpy((x / max(x.max(), 1.0)).astype(np.float32)).cuda()
    y = torch.from_numpy(labels).cuda()
    lap = magnet_propagators(ei, w, q=0.25, num_nodes=n)
    model = MagNet_node_classification(
        num_features=2, hidden=32, K=2, label_dim=5, activation=True,
        layer=2, generator=torch.Generator().manual_seed(0))
    trainer = Trainer(
        lambda m: torch.nn.functional.nll_loss(m(x, x, lap), y), lr=1e-2)
    state = trainer.init(model)

    for _ in range(5):                     # warm-up: cuBLAS, Adam state
        trainer.step_async(state)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(args.steps + 1)]
    ev[0].record()
    for i in range(args.steps):
        trainer.step_async(state)
        ev[i + 1].record()
    torch.cuda.synchronize()
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(args.steps)]
    med = statistics.median(step_ms)
    print(f"step: median {med:.4f} ms, min {min(step_ms):.4f} ms, "
          f"max {max(step_ms):.4f} ms over {args.steps} steps "
          f"({ei.shape[1] / (med / 1e3):.1f} input edges/s)")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        a.record()
        for _ in range(args.steps):
            trainer.step_async(state)
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
              f"{name[:110]}")


if __name__ == "__main__":
    main()
