#!/usr/bin/env python3
"""Time builds of one kernel source with other nvcc flags, or other
versions of the source, in turns on one card.

``csr`` builds ``ops/cuda/csrc/scatter_csr.cu``, ``bsr`` builds
``ops/cuda/csrc/bsr_spmm.cu``, once per variant with its extra nvcc flags;
a flag that names a ``.cu`` file builds that file instead (another version
of the source with the same C interface, such as an edited copy under
``build/``).  All nvcc processes run at once,
into ``build/ab_<kernel>/``.  Then, case by case, each build is swapped in
behind the port's wrappers and timed (median of 20 CUDA-event-timed
calls), in the order given and again in reverse, after its output has been
held against the plain version.  Cases:

  csr  K1 ``csr_dual_spmm`` on the magnet_mxu operator (chip_smoke.py's
       DSBM N=65,536), 2F=64 and 4 f32 and 2F=64 bf16; K2
       ``csr_dual_spmm_accum`` on blocks 0 (hot) and 4 (cold) of the giant
       graph's split+streamed operator, 2F=64 f32 and bf16, with the two
       cuSPARSE ``addmm`` of block 0 timed in the same turns;
       ``csr_dual_spmm`` on chip_smoke.py's synthetic hub CSR.
  bsr  K5 ``bsr_matmul`` on the bsr cell's operator (chip_smoke.py's
       N=8192 graph) and its transpose at W=2 and 32, with the dense
       ``torch.matmul`` and ``torch.sparse.mm`` on a BSR tensor timed in the
       same turns.

Run from the root of a checkout:

    python3 scripts/ab_kernel_variants.py csr new= old=build/scatter_csr_old.cu
    python3 scripts/ab_kernel_variants.py bsr new= lineinfo=-lineinfo
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
    bsr_spmm, build, scatter_csr)
from pytorch_geometric_signed_directed_tpu_torch.spectral import (  # noqa: E402
    magnet_propagators)

KERNELS = {"csr": ("scatter_csr.cu", scatter_csr),
           "bsr": ("bsr_spmm.cu", bsr_spmm)}
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


def in_turns(module, libs, label, fn, extras=()):
    """Time ``fn`` under every build, in order and then in reverse; each
    (name, fn) of ``extras`` is timed in the same turns."""
    runs = [(n, libs[n], fn) for n in libs] + [(n, None, f)
                                                for n, f in extras]
    times = {n: [] for n, _, _ in runs}
    for n, lib, f in runs + runs[::-1]:
        if lib is not None:
            module._lib = lib
        times[n].append(chip_smoke.time_ms(f))
    print(f"{label}: " + ", ".join(
        f"{n} {t[0]:.4f}/{t[1]:.4f}" for n, t in times.items()), flush=True)


def check(module, libs, fn, want, tol):
    for lib in libs.values():
        module._lib = lib
        torch.testing.assert_close(fn(), want, **tol)


def csr_cases(module, libs, gen):
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
    del D

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
    del G, out

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
    va, vb = torch.randn(2, e, generator=gen, device=DEV)
    x = torch.randn(131_072, 64, generator=gen, device=DEV)
    in_turns(module, libs, "hub CSR csr_dual_spmm 2F=64 float32",
             lambda: scatter_csr.csr_dual_spmm(rowptr, col, va, vb, x, 32,
                                               split))


def bsr_cases(module, libs, gen):
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
    if len(sys.argv) < 2 or sys.argv[1] not in KERNELS:
        sys.exit(f"usage: {sys.argv[0]} {{{','.join(KERNELS)}}} "
                 f"name=flags ...")
    variants = {}
    for arg in sys.argv[2:] or ["base="]:
        name, _, flags = arg.partition("=")
        variants[name] = [f for f in flags.split(",") if f]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; ms as (in order)/(in reverse)")
    module, libs = build_variants(sys.argv[1], variants)
    gen = torch.Generator(device=DEV).manual_seed(0)
    (csr_cases if sys.argv[1] == "csr" else bsr_cases)(module, libs, gen)


if __name__ == "__main__":
    main()
