#!/usr/bin/env python3
"""DIGRAC self-supervised clustering at WikiTalk scale on one card.

The PyTorch/CUDA port's counterpart of ``scripts/giant_digrac.py``: the
same ``main`` arguments, command line, printed lines and JSON line.  The
DIMPA trunk and the probabilistic imbalance loss (reference
utils/directed/prob_imbalance_loss.py:104-117) train full-batch on the
N=2.4M / E=10M power-law digraph of ``scripts/bench_giant.py``, with the
walk operators and the adjacency volumes A·P and Aᵀ·P on the kernel
tier.  At this size every operator is column-split (ops/layout.py), and
all but A and Aᵀ of the single operators (7.2M nonzeros, under the
stream's 8M) are streamed as well, so each apply is one K2 call
(``csr_dual_spmm_accum``) a block.  ``--fused`` takes the union-edge-set duals
(``rw_norm_dual_propagator``, ``adj_dual_propagator``) in place of the
four single operators; ``--ab`` runs both.

The objective is the JAX script's: ``Prob_Imbalance_Loss(k)`` keeps the
top ``sel = k`` pairwise scores under 'sort', where the digrac
experiment's 'complete' meta-graph would keep k(k-1)/2.  That quirk of the
reference script is kept on purpose, so both scripts train the same loss.

Precision is the JAX script's: bf16 messages with float32 sums, and
"default" matmul precision (TF32 allowed), both set process-wide by
``main``.  One eager step is the forward, the loss, the backward and
Adam (``train.optim.adam(lr)``, optax's ``adam``); the loss is read once
a step.  On the card, steps 2..``steps`` are timed by CUDA events and 10
more are traced by ``torch.profiler`` for the device time and idle share.

Prints the graph, the host seconds of each stage, each operator's layout
(nnz, blocks, hot columns, cut rows, largest row), the loss trajectory
(it must fall: the exit code is 1 otherwise) and one JSON line whose
``backend`` is the card's name, beside its ``nvidia-smi`` power limit.

Run from the root of the checkout:

    python3 scripts/giant_digrac_torch.py [--fused | --ab]
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# steps traced by torch.profiler for the device time and idle share
PROFILE_STEPS = 10


def powerlaw_digraph(n, e, alpha, seed):
    """``scripts/bench_giant.py``'s generator, bit-equal for the same
    arguments: Zipf(alpha) endpoints, self-loops dropped, node ids
    randomly relabelled."""
    rng = np.random.default_rng(seed)
    w = (np.arange(1, n + 1, dtype=np.float64)) ** -alpha
    cdf = np.cumsum(w)
    cdf /= cdf[-1]

    def zipf_ids(k):
        return np.searchsorted(cdf, rng.random(k)).astype(np.int64)

    row, col = zipf_ids(e), zipf_ids(e)
    keep = row != col
    row, col = row[keep], col[keep]
    # random node relabeling: hubs land at arbitrary ids
    relabel = rng.permutation(n)
    return relabel[row], relabel[col]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def operators(ei, w, n, fused, device, seconds):
    """(P_s, P_t, A_arg) as the JAX script builds them, each operator's
    host seconds (its arrays, coalescing and both layouts on ``device``)
    added to ``seconds`` under its name."""
    from pytorch_geometric_signed_directed_tpu_torch.graph import (
        adj_dual_propagator, norm_propagator, rw_norm_dual_propagator,
        rw_norm_propagator)

    def timed(name, build):
        t0 = time.perf_counter()
        op = build()
        _sync(device)
        seconds[name] = time.perf_counter() - t0
        return op

    rev = ei[[1, 0]]
    if fused:
        P_s = timed("walk dual", lambda: rw_norm_dual_propagator(
            ei, w, n, device=device))
        A_arg = timed("A dual", lambda: adj_dual_propagator(
            ei, w, n, device=device))
        return P_s, None, A_arg
    P_s = timed("P_s", lambda: rw_norm_propagator(ei, w, n, device=device))
    P_t = timed("P_t", lambda: rw_norm_propagator(rev, w, n, device=device))
    A_arg = (timed("P_A", lambda: norm_propagator(rev, w, n, device=device)),
             timed("P_AT", lambda: norm_propagator(ei, w, n, device=device)))
    return P_s, P_t, A_arg


def kernel_view(op):
    """One direction of a kernel-tier operator: a DualPropagator as it is,
    a Propagator's CSR."""
    return op.csr if hasattr(op, "csr") else op


def named_operators(P_s, P_t, A_arg):
    """(name, operator) of the run's kernel-tier operators."""
    if P_t is None:
        return (("walk dual", P_s), ("A dual", A_arg))
    return (("P_s", P_s), ("P_t", P_t), ("P_A", A_arg[0]),
            ("P_AT", A_arg[1]))


def row_lengths(d):
    """Edges of each row of one direction of a kernel-tier operator (a
    CSR, a DualPropagator or a template), summed over the blocks a row's
    edges straddle; rows past the last edge's are left out."""
    if not d.blocks:
        return (d.rowptr[1:] - d.rowptr[:-1]).long()
    n = max(b.row0 + b.rowptr.numel() - 1 for b in d.blocks)
    deg = torch.zeros(n, dtype=torch.long, device=d.col.device)
    for b in d.blocks:
        rows = b.rowptr.numel() - 1
        deg[b.row0:b.row0 + rows] += (b.rowptr[1:] - b.rowptr[:-1]).long()
    return deg


def layout_text(d):
    """nnz, layout, blocks, hot columns, cut rows and the largest row of
    one direction of a kernel-tier operator."""
    nnz = d.col.numel()
    largest = int(row_lengths(d).max()) if nnz else 0
    if not d.blocks:
        return (f"nnz={nnz} flat, cut rows {d.row_split.rows.numel()}, "
                f"largest row {largest}")
    kind = "split+streamed" if d.streamed and d.hot_ids is not None else (
        "streamed" if d.streamed else "split")
    hot = 0 if d.hot_ids is None else d.hot_ids.numel()
    return (f"nnz={nnz} {kind}, {len(d.blocks)} blocks ({d.hot_blocks} "
            f"hot), {hot} hot columns, cut rows "
            f"{sum(b.split.rows.numel() for b in d.blocks)}, largest row "
            f"{largest}")


def make_model(num_features, hidden, k, hop, seed, device):
    """DIGRAC as the JAX script makes it; the weights are drawn from
    ``seed`` (JAX's ``PRNGKey(seed)`` draws cannot be matched)."""
    from pytorch_geometric_signed_directed_tpu_torch.nn import (
        DIGRAC_node_clustering)

    return DIGRAC_node_clustering(
        num_features=num_features, hidden=hidden, nclass=k, fill_value=0.5,
        hop=hop, device=device, generator=torch.Generator().manual_seed(seed))


def imbalance_loss(model, P_s, P_t, A_arg, x, k):
    """The JAX script's objective: ``Prob_Imbalance_Loss(k)`` (sel = k)."""
    from pytorch_geometric_signed_directed_tpu_torch.utils import (
        Prob_Imbalance_Loss)

    prob = model(P_s, P_t, x)[3]
    return Prob_Imbalance_Loss(k)(prob, A_arg, k, "vol_sum", "sort")


def card_text(device):
    """(card name, nvidia-smi power limit) on the card; ("cpu", None)."""
    if device.type != "cuda":
        return "cpu", None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()
    return torch.cuda.get_device_name(device), smi[device.index or 0].strip()


def traced_device_ms(step, steps):
    """Device milliseconds a call of ``step``, the kernels a call and the
    five kernels that take the most device time as (ms a call, name),
    over ``steps`` calls traced by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    # device work only: user annotations also appear on the device
    # timeline and overlap their kernels
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise RuntimeError("the trace holds no device kernels")
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return (sum(by_name.values()) / 1e3 / steps, len(kernels) / steps,
            [(t / 1e3 / steps, name) for name, t in top])


def main(n=2_400_000, e=10_000_000, k=5, hop=2, hidden=32, steps=30,
         lr=1e-2, seed=0, fused=False, device=None, report=None):
    """Train ``steps`` steps and print as the JAX script does; returns 0
    if the loss fell, else 1.  ``device`` None means "cuda".  ``report``,
    a dict, receives the run: ``losses``, ``step_ms``, ``launches`` (the
    kernel wrapper calls of each step), ``host_seconds``, ``ops`` (P_s,
    P_t, A_arg), ``x``, ``summary`` (the JSON line's fields) and, on the
    card, ``device_ms``, ``idle`` and ``peak_bytes``."""
    from pytorch_geometric_signed_directed_tpu_torch.device import (
        resolve_device)
    from pytorch_geometric_signed_directed_tpu_torch.graph import (
        in_out_degree)
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        launch_counts)
    from pytorch_geometric_signed_directed_tpu_torch.ops.spmm import (
        set_matmul_precision, set_message_dtype)
    from pytorch_geometric_signed_directed_tpu_torch.train import adam

    device = resolve_device(device)
    cuda = device.type == "cuda"
    # the JAX script's training precision: bf16 message storage with f32
    # sums, and "default" matmul precision (TF32 allowed on the card)
    set_matmul_precision("default")
    set_message_dtype("bf16")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    seconds = {}

    t0 = time.perf_counter()
    row, col = powerlaw_digraph(n, e, alpha=1.0, seed=seed)
    ei = np.vstack([row, col])
    w = np.ones(len(row), np.float32)
    seconds["graph"] = time.perf_counter() - t0
    print(f"graph: N={n} E={len(row)} ({seconds['graph']:.1f}s)",
          flush=True)

    t0 = time.perf_counter()
    x = in_out_degree(ei, n, edge_weight=w)
    x = torch.from_numpy(x / max(x.max(), 1.0)).to(device)
    _sync(device)
    seconds["features"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    P_s, P_t, A_arg = operators(ei, w, n, fused, device, seconds)
    print(f"propagators built ({time.perf_counter() - t0:.1f}s)", flush=True)
    for name, op in named_operators(P_s, P_t, A_arg):
        if op.mode != "mxu":
            print(f"  {name}: the {op.mode} tier", flush=True)
            continue
        d = kernel_view(op)
        print(f"  {name}: {layout_text(d)}; transposed: "
              f"{layout_text(d.transposed)}", flush=True)
    print("host seconds: " + ", ".join(f"{s} {v:.2f}"
                                       for s, v in seconds.items()),
          flush=True)

    model = make_model(int(x.shape[1]), hidden, k, hop, seed, device)
    opt = adam(lr)(model.parameters())

    def step():
        opt.zero_grad(set_to_none=True)
        loss = imbalance_loss(model, P_s, P_t, A_arg, x, k)
        loss.backward()
        opt.step()
        return loss.detach()

    def mark():
        if not cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    launches, spans, losses = [], [], []
    t0 = time.perf_counter()
    for i in range(steps):
        before = launch_counts()
        a = mark()
        loss = step()
        spans.append((a, mark()))
        after = launch_counts()
        launches.append({name: v - before[name] for name, v in after.items()
                         if v != before[name]})
        losses.append(float(loss))
        if i == 0:
            print(f"compile+step0 ({time.perf_counter() - t0:.1f}s) "
                  f"loss={losses[0]:.4f}", flush=True)
            t1 = time.perf_counter()
    _sync(device)
    step_ms = [a.elapsed_time(b) if cuda else (b - a) * 1e3
               for a, b in spans]
    # steps 2..steps: the mean of the CUDA-event times on the card, the
    # JAX script's host clock on the CPU
    dt = (statistics.fmean(step_ms[1:]) / 1e3 if cuda
          else (time.perf_counter() - t1) / (steps - 1)) if steps > 1 \
        else step_ms[0] / 1e3
    print("loss trajectory:",
          " ".join(f"{v:.4f}" for v in losses[:: max(1, steps // 10)]),
          flush=True)
    print(f"launches a step: {launches[-1]}", flush=True)

    backend, power = card_text(device)
    extra = {}
    if cuda:
        ms_step = statistics.median(step_ms[1:]) if steps > 1 else step_ms[0]
        device_ms, per_step, top = traced_device_ms(step, PROFILE_STEPS)
        extra = dict(device_ms=device_ms, idle=1 - device_ms / ms_step,
                     peak_bytes=torch.cuda.max_memory_allocated(device))
        print(f"device: {device_ms:.4f} ms a step over {PROFILE_STEPS} "
              f"traced steps, {per_step:.1f} kernels; idle share "
              f"{extra['idle']:.3f} of a {ms_step:.3f} ms step (median of "
              f"steps 2..{steps}); peak memory "
              f"{extra['peak_bytes'] / 2 ** 30:.3f} GiB; most: " + "; ".join(
                  f"{t:.4f} {name[:60]}" for t, name in top), flush=True)
    else:
        print("device: not measured (CPU run)", flush=True)
    summary = {
        "metric": "digrac_giant_imbalance_step_s",
        "fused": fused,
        "n": n, "e": len(row), "k": k, "hop": hop,
        "step_seconds": round(dt, 4),
        "input_edges_per_s": round(len(row) / dt, 1),
        "loss_first": round(losses[0], 4),
        "loss_last": round(losses[-1], 4),
        "decreased": losses[-1] < losses[0],
        "backend": backend,
        "power_limit": power,
    }
    print(json.dumps(summary), flush=True)
    if report is not None:
        report.update(losses=losses, step_ms=step_ms, launches=launches,
                      host_seconds=seconds, ops=(P_s, P_t, A_arg), x=x,
                      summary=summary, **extra)
    return 0 if losses[-1] < losses[0] else 1


if __name__ == "__main__":
    fused = "--fused" in sys.argv
    both = "--ab" in sys.argv
    if both:
        rc = main(fused=False)
        torch.cuda.empty_cache()
        rc |= main(fused=True)
        sys.exit(rc)
    sys.exit(main(fused=fused))
