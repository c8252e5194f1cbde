#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

Run from the root of a checkout:  python3 chip_smoke.py

1. Builds every CUDA kernel of the port from the sources (nvcc, in
   parallel) and prints the build time.
2. Kernel phase: holds each kernel against its plain PyTorch version on
   the card — on the MagNet main path's own operator (N=65,536, about 5M
   nonzeros) at the widths it applies (4 and 64), float32 and bf16, and on
   a small graph with duplicate edges and empty rows — and times kernel,
   plain version and one library call beside the least time the card could
   take (bytes over 3.35 TB/s or flops over 67 TFLOP/s, the larger).
3. Slice phase: builds the bench's magnet_mxu configuration through the
   port's public API (DSBM N=65,536, degree features, magnetic Laplacian
   pair at q=0.25, MagNet K=2 hidden 32, 2 layers), checks the kernel
   tier's forward against the plain segment tier on the card and the
   gradients against the CPU on a small graph, then trains 30 Adam steps
   at lr 1e-2 with the launch counters set to 0 just before and read just
   after.

Any failed phase raises, so the exit code is nonzero and no result line
is printed.  The last lines are the card's nvidia-smi name and power
limit, one JSON line of kernel measurements, and
{"ok": true, "device": {...}}.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np

DEV = "cuda"
N = 65_536                   # the bench's magnet_mxu configuration
EXPECTED_E = 2_456_932       # its input edges at seed 0
STEPS = 30
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
F32_FLOPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
REPS = 20
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps=REPS):
    """Median milliseconds of ``reps`` calls, each timed by CUDA events."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def slice_graph(n, avg_deg, seed):
    """The bench's MagNet graph: DSBM with a cyclic meta-graph, normalized
    in/out-degree features."""
    from pytorch_geometric_signed_directed_tpu_torch.data import DSBM
    from pytorch_geometric_signed_directed_tpu_torch.graph import (
        in_out_degree)
    from pytorch_geometric_signed_directed_tpu_torch.utils import (
        meta_graph_generation)

    F = meta_graph_generation("cyclic", 5, 0.05, False)
    p = avg_deg / n
    A, labels = DSBM(n, 5, p * 5 / 2, F, rng=np.random.default_rng(seed))
    edge_index = np.vstack(A.nonzero())
    w = A.tocoo().data
    x = in_out_degree(edge_index, n, edge_weight=w)
    return edge_index, w, (x / max(x.max(), 1.0)).astype(np.float32), labels


def make_model(device, seed=0):
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.nn import (
        MagNet_node_classification)

    return MagNet_node_classification(
        num_features=2, hidden=32, K=2, label_dim=5, activation=True,
        layer=2, device=device,
        generator=torch.Generator().manual_seed(seed))


def dual_kernel_case(D, width, dtype, seed):
    """Kernel vs plain vs library on operator D at one width and type."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        scatter_csr)

    n, m, nnz = D.num_nodes, D.num_cols, D.col.numel()
    gen = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn(m, width, device=DEV, generator=gen).to(dtype)
    fa = width // 2
    args = (D.rowptr, D.col, D.val_a, D.val_b, x, fa)
    got = scatter_csr.csr_dual_spmm(*args)
    want = scatter_csr.csr_dual_spmm_plain(*args)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    # the plain version on the card sums with atomics, in no fixed order
    torch.testing.assert_close(got, want, **tol)
    if not torch.equal(got, scatter_csr.csr_dual_spmm(*args)):
        raise AssertionError("csr_dual_spmm is not deterministic")
    err = float((got - want).abs().max())
    ms = time_ms(lambda: scatter_csr.csr_dual_spmm(*args))
    plain_ms = time_ms(lambda: scatter_csr.csr_dual_spmm_plain(*args))
    library_ms = None
    if dtype == torch.float32:
        # yardstick only: two cuSPARSE products, A x_a and B x_b
        rp, cl = D.rowptr.long(), D.col.long()
        A = torch.sparse_csr_tensor(rp, cl, D.val_a, size=(n, m))
        B = torch.sparse_csr_tensor(rp, cl, D.val_b, size=(n, m))
        xa, xb = x[:, :fa].contiguous(), x[:, fa:].contiguous()
        lib = torch.cat([torch.sparse.mm(A, xa), torch.sparse.mm(B, xb)], 1)
        torch.testing.assert_close(lib, want, **tol)
        library_ms = time_ms(lambda: (torch.sparse.mm(A, xa),
                                      torch.sparse.mm(B, xb)))
    nbytes = 4 * (n + 1) + 12 * nnz + x.numel() * x.element_size() + 4 * n * width
    b_ms, b_by = bound(nbytes, 2 * nnz * width)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, bytes=nbytes)


def scatter_kernel_case(rowptr, nnz, width, dtype, seed):
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        scatter_csr)

    n = rowptr.numel() - 1
    gen = torch.Generator(device=DEV).manual_seed(seed)
    msgs = torch.randn(nnz, width, device=DEV, generator=gen).to(dtype)
    got = scatter_csr.csr_scatter_sum(rowptr, msgs)
    want = scatter_csr.csr_scatter_sum_plain(rowptr, msgs)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got, want, **tol)
    err = float((got - want).abs().max())
    ms = time_ms(lambda: scatter_csr.csr_scatter_sum(rowptr, msgs))
    plain_ms = time_ms(lambda: scatter_csr.csr_scatter_sum_plain(rowptr,
                                                                 msgs))
    library_ms = None
    if dtype == torch.float32:
        # yardstick only: one segment_reduce over the same rowptr
        offsets = rowptr.long()
        lib = torch.segment_reduce(msgs, "sum", offsets=offsets, axis=0)
        torch.testing.assert_close(lib, want, **tol)
        library_ms = time_ms(lambda: torch.segment_reduce(
            msgs, "sum", offsets=offsets, axis=0))
    nbytes = 4 * (n + 1) + msgs.numel() * msgs.element_size() + 4 * n * width
    b_ms, b_by = bound(nbytes, nnz * width)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, bytes=nbytes)


def small_graph_checks():
    """Duplicate edges, empty rows, ragged widths: kernel vs plain."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.ops import spmm
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        scatter_csr)

    rng = np.random.default_rng(1)
    n_rows, n_cols, e = 3000, 2000, 40000
    row = rng.integers(0, n_rows // 2, e) * 2        # odd rows empty
    col = rng.integers(0, n_cols, e)
    row[:4000], col[:4000] = row[-4000:], col[-4000:]  # duplicates
    va = rng.standard_normal(e).astype(np.float32)
    vb = rng.standard_normal(e).astype(np.float32)
    D = spmm.dual_propagator(row, col, va, vb, n_rows, n_cols, mode="mxu",
                             device=DEV)
    for dtype in (torch.float32, torch.bfloat16):
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        for width in (2, 4, 38, 64, 300):
            x = torch.randn(n_cols, width, device=DEV).to(dtype)
            args = (D.rowptr, D.col, D.val_a, D.val_b, x, width // 2)
            got = scatter_csr.csr_dual_spmm(*args)
            torch.testing.assert_close(
                got, scatter_csr.csr_dual_spmm_plain(*args), **tol)
            if got[1::2].abs().max() != 0:
                raise AssertionError("an empty row was not zeroed")
            msgs = torch.randn(e, width, device=DEV).to(dtype)
            torch.testing.assert_close(
                scatter_csr.csr_scatter_sum(D.rowptr, msgs),
                scatter_csr.csr_scatter_sum_plain(D.rowptr, msgs), **tol)
    log("small graph (duplicates, empty rows, widths 2/4/38/64/300, "
        "f32+bf16): kernels agree with their plain versions")


def small_model_check():
    """Forward and every gradient of the kernel tier on the card against
    the same model on the CPU (plain versions), at N=3000."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.spectral import (
        magnet_propagators)

    ei, w, x, y = slice_graph(3000, 30, seed=1)
    outs = {}
    for dev in (DEV, "cpu"):
        lap = magnet_propagators(ei, w, q=0.25, num_nodes=3000, mode="mxu",
                                 device=dev)
        model = make_model(dev, seed=1)
        xt = torch.from_numpy(x).to(dev)
        logp = model(xt, xt, lap)
        torch.nn.functional.nll_loss(
            logp, torch.from_numpy(y).to(dev)).backward()
        outs[dev] = [logp.detach()] + [p.grad for p in model.parameters()]
    for a, b in zip(outs[DEV], outs["cpu"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    log("small model (N=3000, mxu tier): card forward and all parameter "
        "gradients agree with the CPU at 1e-4")


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() "
                 "is False")
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        build, scatter_csr)
    from pytorch_geometric_signed_directed_tpu_torch.spectral import (
        magnet_propagators)
    from pytorch_geometric_signed_directed_tpu_torch.train import Trainer

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {kind}")

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in secs.items()) or 'cached'})")
    for name, text in build.BUILD_LOG.items():
        print(f"--- nvcc {name}\n{text}", file=sys.stderr)

    # ---- host set-up of the slice (also the kernel phase's operator) ----
    n = N
    t0 = time.perf_counter()
    ei, w, x_np, y_np = slice_graph(n, 30, seed=0)
    e = ei.shape[1]
    lap = magnet_propagators(ei, w, q=0.25, num_nodes=n, mode="auto",
                             device=DEV)
    torch.cuda.synchronize()
    D = lap.dual
    if D is None or D.mode != "mxu":
        raise AssertionError("mode='auto' did not pick the kernel tier")
    nnz = D.col.numel()
    log(f"slice graph: N={n} E={e} Laplacian nnz={nnz} "
        f"(built in {time.perf_counter() - t0:.2f} s)")
    if EXPECTED_E is not None and e != EXPECTED_E:
        raise AssertionError(f"expected the bench's E={EXPECTED_E}, got {e}")

    # ---- 2. kernel phase --------------------------------------------------
    small_graph_checks()
    cases = {}
    for width in (4, 64):
        for dtype in (torch.float32, torch.bfloat16):
            for op, d in (("fwd", D), ("bwd", D.transposed)):
                r = dual_kernel_case(d, width, dtype, seed=width)
                cases[("csr_dual_spmm", width, dtype, op)] = r
                log(f"csr_dual_spmm {op} W={width} {str(dtype)[6:]}: "
                    f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                    f"library_ms={r['library_ms']} "
                    f"bound_us={r['bound_ms'] * 1e3:.2f} ({r['bound_by']}, "
                    f"{r['bytes']} B) max_abs_err={r['max_abs_err']:.3g}")
    for width in (4, 64):
        for dtype in (torch.float32, torch.bfloat16):
            r = scatter_kernel_case(D.rowptr, nnz, width, dtype, seed=width)
            cases[("csr_scatter_sum", width, dtype)] = r
            log(f"csr_scatter_sum W={width} {str(dtype)[6:]}: "
                f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                f"library_ms={r['library_ms']} "
                f"bound_us={r['bound_ms'] * 1e3:.2f} ({r['bound_by']}) "
                f"max_abs_err={r['max_abs_err']:.3g}")

    # ---- 3. slice phase ---------------------------------------------------
    small_model_check()
    x = torch.from_numpy(x_np).to(DEV)
    y = torch.from_numpy(y_np).to(DEV)
    model = make_model(DEV, seed=0)
    lap_plain = magnet_propagators(ei, w, q=0.25, num_nodes=n,
                                   mode="segment", device=DEV)
    with torch.no_grad():
        torch.testing.assert_close(model(x, x, lap),
                                   model(x, x, lap_plain),
                                   rtol=1e-4, atol=1e-4)
    log("slice forward: kernel tier agrees with the segment tier at 1e-4")
    del lap_plain

    def loss_fn(m):
        return torch.nn.functional.nll_loss(m(x, x, lap), y)

    trainer = Trainer(loss_fn, lr=1e-2, device=DEV)
    state = trainer.init(model)
    steps = STEPS
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    torch.cuda.synchronize()
    scatter_csr.reset_launch_counts()
    t0 = time.perf_counter()
    events[0].record()
    losses = []
    for i in range(steps):
        losses.append(trainer.step_async(state))
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(scatter_csr.LAUNCHES)
    losses = [float(v) for v in losses]
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses[0]} -> "
                             f"{losses[-1]}")
    per_step = launches["csr_dual_spmm"] / steps
    if launches["csr_dual_spmm"] != 6 * steps:
        raise AssertionError(f"expected 6 csr_dual_spmm launches per step, "
                             f"got {per_step}")
    with torch.no_grad():
        acc = float((model(x, x, lap).argmax(1) == y).float().mean())
    ms_step = statistics.median(step_ms[1:])
    log(f"slice train: {steps} steps, loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}, train acc {acc:.4f}; "
        f"launches {launches} ({per_step:g} csr_dual_spmm per step)")
    log(f"slice speed on {smi}: median {ms_step:.3f} ms/step "
        f"(first step {step_ms[0]:.3f} ms, mean {wall / steps * 1e3:.3f} ms "
        f"by host clock), {e / (ms_step / 1e3):.1f} input edges/s")

    def entry(name, key, source):
        r = cases[key]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": "pytorch_geometric_signed_directed_tpu/ops/"
                            "pallas/scatter_mxu.py:503",
                "launches": launches[name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "shape": f"N={n} nnz={nnz} W={key[1]} {str(key[2])[6:]}"}

    src = "pytorch_geometric_signed_directed_tpu_torch/ops/cuda/csrc/scatter_csr.cu"
    print(smi)
    print(json.dumps({
        "kernels": [entry("csr_dual_spmm",
                          ("csr_dual_spmm", 64, torch.float32, "fwd"), src)],
        # K1's plain segment-sum entry: tested, on no path yet
        "off_path": [entry("csr_scatter_sum",
                           ("csr_scatter_sum", 64, torch.float32), src)],
    }))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
