#!/usr/bin/env python3
"""Time builds of one kernel source with other nvcc flags, or other
versions of the source, in turns on one card.

``csr`` builds ``ops/cuda/csrc/scatter_csr.cu``, ``bsr`` builds
``ops/cuda/csrc/bsr_spmm.cu``, ``sddmm`` builds
``ops/cuda/csrc/dual_sddmm.cu``, once per variant with its extra nvcc flags;
a flag that names a ``.cu`` file builds that file instead (another version
of the source with the same C interface, such as an edited copy under
``build/``).  All nvcc processes run at once,
into ``build/ab_<kernel>/`` (each with its compiler report beside it, a
``.log``).  Then, case by case, each build is swapped in
behind the port's wrappers and timed (20 calls back to back between two
CUDA events, per call), in the order given and again in reverse, after its
output has been held against the plain version.  Cases:

  csr  K1 ``csr_dual_spmm`` on the magnet_mxu operator (chip_smoke.py's
       DSBM N=65,536), 2F=64 and 4 f32 and 2F=64 bf16; K2
       ``csr_dual_spmm_accum`` on blocks 0 (hot) and 4 (cold) of the giant
       graph's split+streamed operator, 2F=64 f32 and bf16, with the two
       cuSPARSE ``addmm`` of block 0 timed in the same turns;
       ``csr_dual_spmm`` on chip_smoke.py's synthetic hub CSR; K1
       ``csr_pair_spmm`` on the trainable-q template (the magnet_mxu
       graph's), 2F=4 and 64 f32 and 2F=64 bf16, with the four cuSPARSE
       products of 2F=64 f32 in the same turns; ``csr_scatter_sum`` on the
       template's rowptr at W=8 and 128 f32, with ``torch.segment_reduce``
       in the same turns.
  bsr  K5 ``bsr_matmul`` on the bsr cell's operator (chip_smoke.py's
       N=8192 graph) and its transpose at W=2 and 32, with the dense
       ``torch.matmul`` and ``torch.sparse.mm`` on a BSR tensor timed in the
       same turns.
  sddmm  K4 ``csr_dual_sddmm_accum`` on hot block 0 of the split
       transposed trainable-q template (chip_smoke.py's case), K3
       ``csr_dual_sddmm`` on the transposed template at 2F=4 and 64 f32
       (the composite of four cuSPARSE products in the same turns at
       2F=64), and on chip_smoke.py's hub CSR at 2F=64.

``--only a,b`` runs only the named groups of cases: ``dual``, ``giant``,
``hub``, ``pair`` and ``scatter`` of ``csr``; ``template`` and ``hub`` of
``sddmm``.

Run from the root of a checkout:

    python3 scripts/ab_kernel_variants.py csr new= old=build/scatter_csr_old.cu
    python3 scripts/ab_kernel_variants.py csr --only pair,scatter new= \
        maxreg=-maxrregcount=64
    python3 scripts/ab_kernel_variants.py bsr new= lineinfo=-lineinfo
    python3 scripts/ab_kernel_variants.py sddmm new= old=build/dual_sddmm_old.cu
"""
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (  # noqa: E402
    bsr_spmm, build, dual_sddmm, scatter_csr)
from pytorch_geometric_signed_directed_tpu_torch.spectral import (  # noqa: E402
    magnet_propagators, magnetic_template)

KERNELS = {"csr": ("scatter_csr.cu", scatter_csr),
           "bsr": ("bsr_spmm.cu", bsr_spmm),
           "sddmm": ("dual_sddmm.cu", dual_sddmm)}
DEV = "cuda"


def build_variants(kernel, variants):
    """{name: bound library} of the kernel's source built per variant."""
    source, module = KERNELS[kernel]
    out = os.path.join(os.path.dirname(build.BUILD_DIR), f"ab_{kernel}")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, flags in variants.items():
        src = next((f for f in flags if f.endswith(".cu")),
                   os.path.join(build.CSRC, source))
        flags = [f for f in flags if not f.endswith(".cu")]
        path = os.path.join(out, f"lib{kernel}_{name}.so")
        procs[name] = (path, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, *flags,
             "-o", path, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        with open(path[:-3] + ".log", "w") as f:  # the ptxas report
            f.write(log)
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        regs = sorted({int(line.split("Used ")[1].split()[0])
                       for line in log.splitlines() if "registers" in line})
        spills = sum("0 bytes spill stores" not in line
                     for line in log.splitlines() if "spill stores" in line)
        print(f"{name} {variants[name]}: registers {regs[0]}-{regs[-1]}, "
              f"{spills} kernels spill")
        libs[name] = module.bind(ctypes.CDLL(path))
    return module, libs


def per_call_ms(fn, reps=20):
    """Milliseconds per call of ``fn`` called ``reps`` times back to back
    between two CUDA events: the device's time whenever the host enqueues
    a call faster than the card runs it (the wrappers' host work would
    otherwise add to a short kernel's time)."""
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def in_turns(module, libs, label, fn, extras=()):
    """Time ``fn`` under every build, in order and then in reverse; each
    (name, fn) of ``extras`` is timed in the same turns."""
    runs = [(n, libs[n], fn) for n in libs] + [(n, None, f)
                                                for n, f in extras]
    times = {n: [] for n, _, _ in runs}
    for n, lib, f in runs + runs[::-1]:
        if lib is not None:
            module._lib = lib
        times[n].append(per_call_ms(f))
    print(f"{label}: " + ", ".join(
        f"{n} {t[0]:.4f}/{t[1]:.4f}" for n, t in times.items()), flush=True)


def check(module, libs, fn, want, tol):
    for lib in libs.values():
        module._lib = lib
        torch.testing.assert_close(fn(), want, **tol)


def csr_cases(module, libs, gen, want):
    if want("dual"):
        dual_cases(module, libs, gen)
    if want("giant"):
        giant_cases(module, libs, gen)
    if want("hub"):
        rowptr, split, col, vals, x = hub_csr(gen)
        msgs = torch.randn(col.numel(), 64, device=DEV, generator=gen)
        hub = {"csr_dual_spmm": (rowptr, col, *vals[:2], x, 32),
               "csr_pair_spmm": (rowptr, col, *vals, x, 32),
               "csr_scatter_sum": (rowptr, msgs)}
        for name, args in hub.items():
            fn = getattr(scatter_csr, name)
            # a hub row's compensated f32 sum is ~1e-5 from float64, which
            # F32_TOL misses where the row's sum cancels to near 0
            check(module, libs, lambda: fn(*args, split),
                  getattr(scatter_csr, name + "_plain")(*args),
                  chip_smoke.LIBRARY_TOL)
            in_turns(module, libs, f"hub CSR {name} W=64 float32",
                     lambda: fn(*args, split))
    if want("pair") or want("scatter"):
        t = template()
        if want("pair"):
            pair_cases(module, libs, gen, t)
        if want("scatter"):
            scatter_cases(module, libs, gen, t)


def pair_cases(module, libs, gen, t):
    f32, bf16 = torch.float32, torch.bfloat16
    terms = chip_smoke.template_terms(t, torch.tensor(0.25, device=DEV))
    for width, dt in ((4, f32), (64, f32), (64, bf16)):
        x = torch.randn(t.num_nodes, width, device=DEV,
                        generator=gen).to(dt)
        args = (t.rowptr, t.col, *terms, x, width // 2)
        check(module, libs,
              lambda: scatter_csr.csr_pair_spmm(*args, t.row_split),
              scatter_csr.csr_pair_spmm_plain(*args),
              chip_smoke.F32_TOL if dt == f32 else chip_smoke.BF16_TOL)
        extras = ()
        if width == 64 and dt == f32:
            extras = (("4x sparse.mm", chip_smoke.four_products(
                t.rowptr, t.col, terms, x, 32, t.num_nodes)),)
        in_turns(module, libs, f"K1 pair template 2F={width} {str(dt)[6:]}",
                 lambda: scatter_csr.csr_pair_spmm(*args, t.row_split),
                 extras)


def scatter_cases(module, libs, gen, t):
    f32, bf16 = torch.float32, torch.bfloat16
    offsets = t.rowptr.long()
    for width, dt in ((8, f32), (128, f32), (8, bf16)):
        msgs = torch.randn(t.col.numel(), width, device=DEV,
                           generator=gen).to(dt)
        check(module, libs,
              lambda: scatter_csr.csr_scatter_sum(t.rowptr, msgs,
                                                  t.row_split),
              scatter_csr.csr_scatter_sum_plain(t.rowptr, msgs),
              chip_smoke.F32_TOL if dt == f32 else chip_smoke.BF16_TOL)
        extras = ()
        if dt == f32:
            extras = (("segment_reduce", lambda: torch.segment_reduce(
                msgs, "sum", offsets=offsets, axis=0)),)
        in_turns(module, libs,
                 f"K1 scatter template W={width} {str(dt)[6:]}",
                 lambda: scatter_csr.csr_scatter_sum(t.rowptr, msgs,
                                                     t.row_split), extras)


def dual_cases(module, libs, gen):
    f32, bf16 = torch.float32, torch.bfloat16
    ei, w, _, _ = chip_smoke.slice_graph(chip_smoke.N, 30, seed=0)
    D = magnet_propagators(ei, w, q=0.25, num_nodes=chip_smoke.N,
                           mode="auto", device=DEV).dual
    for width, dt in ((64, f32), (4, f32), (64, bf16)):
        x = torch.randn(D.num_cols, width, device=DEV, generator=gen).to(dt)
        args = (D.rowptr, D.col, D.val_a, D.val_b, x, width // 2)
        check(module, libs,
              lambda: scatter_csr.csr_dual_spmm(*args, D.row_split),
              scatter_csr.csr_dual_spmm_plain(*args),
              chip_smoke.F32_TOL if dt == f32 else chip_smoke.BF16_TOL)
        in_turns(module, libs, f"K1 magnet_mxu fwd 2F={width} {str(dt)[6:]}",
                 lambda: scatter_csr.csr_dual_spmm(*args, D.row_split))


def giant_cases(module, libs, gen):
    f32, bf16 = torch.float32, torch.bfloat16
    g = chip_smoke.GIANT
    n = g["nodes"]
    row, col = chip_smoke.powerlaw_digraph(n, g["edges"], g["alpha"],
                                           seed=g["seed"])
    G = magnet_propagators(np.vstack([row, col]),
                           np.ones(len(row), np.float32), q=0.25,
                           num_nodes=n, mode="mxu", device=DEV).dual
    out = torch.zeros(n, 64, device=DEV)
    for i in (0, len(G.blocks) - 1):
        b = G.blocks[i]
        table = G.hot_ids.numel() if i < G.hot_blocks else n
        for dt in (f32, bf16):
            x = torch.randn(table, 64, device=DEV, generator=gen).to(dt)
            args = (b.rowptr, G.col[b.e0:b.e1], G.val_a[b.e0:b.e1],
                    G.val_b[b.e0:b.e1], x, 32)
            check(module, libs, lambda: scatter_csr.csr_dual_spmm_accum(
                *args, out.clone(), b.row0, b.split),
                scatter_csr.csr_dual_spmm_accum_plain(*args, out, b.row0),
                chip_smoke.F32_TOL if dt == f32 else chip_smoke.BF16_TOL)
            extras = ()
            if i == 0 and dt == f32:
                rows = b.rowptr.numel() - 1
                rp, cl = b.rowptr.long(), args[1].long()
                A = torch.sparse_csr_tensor(rp, cl, args[2],
                                            size=(rows, table))
                B = torch.sparse_csr_tensor(rp, cl, args[3],
                                            size=(rows, table))
                oa = out[b.row0:b.row0 + rows, :32].contiguous()
                ob = out[b.row0:b.row0 + rows, 32:].contiguous()
                xa, xb = x[:, :32].contiguous(), x[:, 32:].contiguous()
                extras = (("2x addmm", lambda: (torch.addmm(oa, A, xa),
                                                torch.addmm(ob, B, xb))),)
            in_turns(module, libs, f"K2 giant block {i} 2F=64 {str(dt)[6:]}",
                     lambda: scatter_csr.csr_dual_spmm_accum(
                         *args, out, b.row0, b.split), extras)


def hub_csr(gen):
    """chip_smoke.py's hub CSR (the giant graph's 324,064-edge row, rows
    around the piece length, 10^5 short rows) over a 131,072-row table,
    with four per-edge values and a 2F=64 table."""
    L = scatter_csr.PIECE_EDGES
    lengths = np.concatenate([[324_064, 0, L - 1, L, L + 1, 2 * L + 5, 0],
                              np.random.default_rng(8).integers(0, 8,
                                                                100_000)])
    rowptr = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(lengths)]).astype(np.int32)).to(DEV)
    split = scatter_csr.plan_row_split(rowptr)
    e = int(lengths.sum())
    col = torch.randint(0, 131_072, (e,), generator=gen, device=DEV,
                        dtype=torch.int32)
    vals = torch.randn(4, e, generator=gen, device=DEV)
    x = torch.randn(131_072, 64, generator=gen, device=DEV)
    return rowptr, split, col, tuple(vals), x


def template():
    """The trainable-q template of the magnet_mxu graph (flat, mxu)."""
    ei, w, _, _ = chip_smoke.slice_graph(chip_smoke.N, 30, seed=0)
    return magnetic_template(ei, w, num_nodes=chip_smoke.N, mode="auto",
                             device=DEV)


def sddmm_cases(module, libs, gen, want):
    if want("template"):
        sddmm_template_cases(module, libs, gen)
    if not want("hub"):
        return
    rowptr, split, col, vals, g = hub_csr(gen)
    x = torch.randn(rowptr.numel() - 1, 64, device=DEV, generator=gen)
    args = (rowptr, col, *vals, g, x, 32)
    check(module, libs, lambda: dual_sddmm.csr_dual_sddmm(*args, split),
          dual_sddmm.csr_dual_sddmm_plain(*args), chip_smoke.LIBRARY_TOL)
    in_turns(module, libs, "K3 hub CSR 2F=64 float32",
             lambda: dual_sddmm.csr_dual_sddmm(*args, split))


def sddmm_template_cases(module, libs, gen):
    ei, w, _, _ = chip_smoke.slice_graph(chip_smoke.N, 30, seed=0)
    n = chip_smoke.N
    # K4 on hot block 0 of the split transposed template, as chip_smoke.py
    # times it
    L = chip_smoke.with_knobs(lambda: magnetic_template(
        ei, w, num_nodes=n, mode="mxu", device=DEV),
        COL_SPLIT_MIN_COLS=n // 2, GATHER_FAST_ROWS=n // 4,
        COL_SPLIT_MIN_COVERAGE=0.0).transposed
    q = torch.tensor(0.25, device=DEV)
    b, s = L.blocks[0], slice(L.blocks[0].e0, L.blocks[0].e1)
    args = (b.rowptr, L.col[s],
            *(v[s] for v in chip_smoke.template_terms(L, q)),
            torch.randn(L.hot_ids.numel(), 64, device=DEV, generator=gen),
            torch.randn(n, 64, device=DEV, generator=gen), 32)
    out, acc = torch.zeros(n, 64, device=DEV), torch.zeros(64, device=DEV)
    check(module, libs, lambda: dual_sddmm.csr_dual_sddmm_accum(
        *args, out.clone(), acc.clone(), b.row0, b.split),
        dual_sddmm.csr_dual_sddmm_accum_plain(*args, out, acc, b.row0),
        chip_smoke.ACC_TOL)
    in_turns(module, libs, "K4 split transposed template block 0 2F=64 "
             "float32", lambda: dual_sddmm.csr_dual_sddmm_accum(
                 *args, out, acc, b.row0, b.split))
    del L
    t = magnetic_template(ei, w, num_nodes=n, mode="auto",
                          device=DEV).transposed
    q = torch.tensor(0.25, device=DEV)
    terms = chip_smoke.template_terms(t, q)
    n = t.num_nodes
    for width in (4, 64):
        g = torch.randn(n, width, device=DEV, generator=gen)
        x = torch.randn(n, width, device=DEV, generator=gen)
        args = (t.rowptr, t.col, *terms, g, x, width // 2)
        check(module, libs,
              lambda: dual_sddmm.csr_dual_sddmm(*args, t.row_split),
              dual_sddmm.csr_dual_sddmm_plain(*args), chip_smoke.ACC_TOL)
        extras = ()
        if width == 64:
            extras = (("composite", chip_smoke.composite_sddmm(
                t.rowptr, t.col, terms, g, x, 32, n)),)
        in_turns(module, libs, f"K3 transposed template 2F={width} float32",
                 lambda: dual_sddmm.csr_dual_sddmm(*args, t.row_split),
                 extras)


def bsr_cases(module, libs, gen, want):
    cfg = chip_smoke.BSR_GRAPH
    ei, w, _, _ = chip_smoke.slice_graph(cfg["nodes"], cfg["avg_deg"],
                                         seed=cfg["seed"])
    B = magnet_propagators(ei, w, q=0.25, num_nodes=cfg["nodes"],
                           mode="bsr", device=DEV).re.bsr
    for width in (2, 32):
        for name, op in (("fwd", B), ("bwd", B.transposed)):
            x = torch.randn(op.num_cols, width, device=DEV, generator=gen)
            args = (op.blocks, op.block_rowptr, op.block_cols, x,
                    op.num_rows)
            check(module, libs, lambda: bsr_spmm.bsr_matmul(*args, op.split),
                  bsr_spmm.bsr_matmul_plain(*args), chip_smoke.F32_TOL)
            dense = chip_smoke.dense_of(op)
            A = torch.sparse_bsr_tensor(
                op.block_rowptr.long(), op.block_cols.long(), op.blocks,
                size=(dense.shape[0], dense.shape[1]))
            extras = (("dense matmul", lambda: torch.matmul(dense, x)),
                      ("sparse.mm BSR", lambda: torch.sparse.mm(A, x)))
            in_turns(module, libs, f"K5 bsr {name} W={width}",
                     lambda: bsr_spmm.bsr_matmul(*args, op.split), extras)
            del dense, A


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    args = sys.argv[1:]
    if not args or args[0] not in KERNELS:
        sys.exit(f"usage: {sys.argv[0]} {{{','.join(KERNELS)}}} "
                 f"[--only group,...] name=flags ...")
    kernel, args = args[0], args[1:]
    only = None
    if args[:1] == ["--only"]:
        only, args = set(args[1].split(",")), args[2:]
    variants = {}
    for arg in args or ["base="]:
        name, _, flags = arg.partition("=")
        variants[name] = [f for f in flags.split(",") if f]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; ms as (in order)/(in reverse)")
    module, libs = build_variants(kernel, variants)
    gen = torch.Generator(device=DEV).manual_seed(0)
    cases = {"csr": csr_cases, "bsr": bsr_cases, "sddmm": sddmm_cases}
    cases[kernel](module, libs, gen,
                  lambda group: only is None or group in only)


if __name__ == "__main__":
    main()
