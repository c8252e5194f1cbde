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
output has been held against the plain version; then once more as the
replay of a CUDA graph of 20 calls, the device's time without the host's
work a call (a third number).  Cases:

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
       in the same turns; K2 on block 0 of scripts/giant_digrac_torch.py's
       operators (P_s at W=32, P_A at W=5, the walk dual at 2F=64 and the
       A dual at 2K=10), f32 and bf16, with their ``addmm`` (f32) in the
       same turns; ``csr_scatter_sum`` on chip_smoke.py's phase-10 CSRs
       (the bench SNEA and epinions-size SNEA graphs at W=17 and 34, the
       bench SiGAT motif 0 and motif stack at W=21 and 1), with
       ``torch.segment_reduce`` in the same turns, and on power-law CSRs
       of uncut rows of 40 to 1,024 edges at W=1, 5, 17, 21 and 34 and
       from an unaligned base at W=64.  ``paths``: K1 on msgnn_link's flat operator
       (N=9000) at 2F=8 and 128, K2 on block 0 of DGCN's streamed A_in at
       W=32, K1 on the bench SGCN dual at 2F=128 and 64 and on the bench
       DiGCL operator at W=128 and 64 (chip_smoke.py phases 7-11).
  bsr  K5 ``bsr_matmul`` on the bsr cell's operator (chip_smoke.py's
       N=8192 graph) and its transpose at W=2 and 32, on the operator at
       W=1, 8 and 64, and on shard 0 of its four-shard partition at W=32,
       with the dense ``torch.matmul`` and ``torch.sparse.mm`` on a BSR
       tensor timed in the same turns.  ``--ctas a,b`` also times every
       build under plans of a and b CTAs an SM (``CTAS_PER_SM``).  A build
       from before the tensor-core design (no ``pgsd_bsr_config``) is
       called without the block count.
  sddmm  K4 ``csr_dual_sddmm_accum`` on hot block 0 of the split
       transposed trainable-q template (chip_smoke.py's case), K3
       ``csr_dual_sddmm`` on the transposed template at 2F=4 and 64 f32
       (the composite of four cuSPARSE products in the same turns at
       2F=64), and on chip_smoke.py's hub CSR at 2F=64.

``--only a,b`` runs only the named groups of cases: ``dual``, ``giant``,
``hub``, ``pair``, ``scatter``, ``giant_digrac``, ``odd``, ``paths`` and
``gather`` (the card's L2 gather rate, no build timed) of ``csr``;
``template`` and ``hub`` of ``sddmm``.

A build of ``scatter_csr.cu`` from before the dual's wide row blocks (no
``pgsd_csr_dual_tile``) is called without their flag, and one from
before the row blocks (no ``pgsd_csr_block_shape``) also without the
plan's block arguments, and one from before K1's indexed messages is
bound without that entry,
so the parent commit's source times against today's behind the same
wrappers (``git show HEAD~1:<path> > build/scatter_csr_parent.cu``, with
the parent's ``csr_common.cuh`` beside it; at V = 1 it is given the TL
it was built for).  A build of another row-block shape
(``-DPGSD_BLOCK_EDGES=16``, ``-DPGSD_BLOCK_ROWS=16``) or walked-row
length (``-DPGSD_WALK_EDGES=32``, the longest row a thread walks alone
at V = 1) is bound with scatter_csr's BLOCK_EDGES, BLOCK_ROWS and
WALK_EDGES set to its own, and is given each CSR planned at them; only
the cases that take their plan (``giant_digrac``, ``odd`` and
``paths``) time it, the others leave it out.

Run from the root of a checkout:

    python3 scripts/ab_kernel_variants.py csr new= old=build/scatter_csr_old.cu
    python3 scripts/ab_kernel_variants.py csr --only giant_digrac,odd \
        old=build/parent/scatter_csr.cu new= t16=-DPGSD_BLOCK_EDGES=16
    python3 scripts/ab_kernel_variants.py csr --only pair,scatter new= \
        maxreg=-maxrregcount=64
    python3 scripts/ab_kernel_variants.py bsr new= lineinfo=-lineinfo
    python3 scripts/ab_kernel_variants.py bsr --ctas 4 \
        old=build/parent/bsr_spmm.cu new=
    python3 scripts/ab_kernel_variants.py sddmm new= old=build/dual_sddmm_old.cu
"""
import contextlib
import ctypes
import functools
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

# csr builds that read row blocks: their shape (edges, rows, walk)
SHAPES = {}
KERNELS = {"csr": ("scatter_csr.cu", scatter_csr),
           "bsr": ("bsr_spmm.cu", bsr_spmm),
           "sddmm": ("dual_sddmm.cu", dual_sddmm)}
DEV = "cuda"


class LegacyBsrBuild:
    """A build of bsr_spmm.cu from before the tensor-core design (no
    ``pgsd_bsr_config``): its pgsd_bsr_spmm takes no block count, which a
    call here drops."""

    def __init__(self, lib):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pgsd_bsr_spmm.restype = i
        lib.pgsd_bsr_spmm.argtypes = [p] * 7 + [i] * 4 + [p]
        self._lib = lib

    def pgsd_bsr_spmm(self, *args):
        return self._lib.pgsd_bsr_spmm(*args[:8], *args[9:])


class PlanlessBuild:
    """A build of scatter_csr.cu from before the row blocks: its entries
    take the plan without the six block arguments (blocks, mids and walks,
    the last six before the stream), which a call here drops.  At V = 1 its pgsd_csr_scatter
    reads TL, which the wrapper no longer computes: a call here gives it
    the rule it was built for, min(32, the power of two >= W)."""

    def __init__(self, lib):
        p, i = ctypes.c_void_p, ctypes.c_int
        plan = [p, i, p, p, i, i, p]
        for name, head in (("pgsd_csr_dual_spmm", [p] * 6 + [i] * 6),
                           ("pgsd_csr_pair_spmm", [p] * 8 + [i] * 6),
                           ("pgsd_csr_scatter", [p, p, p] + [i] * 7)):
            fn = getattr(lib, name)
            fn.restype = i
            fn.argtypes = head + plan + [p]
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name == "pgsd_csr_dual_spmm":
            return lambda *args: fn(*args[:12], *args[13:-7], args[-1])
        if name != "pgsd_csr_scatter":
            return lambda *args: fn(*args[:-7], args[-1])

        def scatter(*args):
            args = list(args)
            if args[8] == 1:  # V = 1: TL from the width
                args[9] = min(32, 1 << (args[4] - 1).bit_length())
            return fn(*args[:-7], args[-1])
        return scatter


class UntiledBuild:
    """A build of scatter_csr.cu with row blocks but from before the dual's
    wide row blocks (no ``pgsd_csr_dual_tile``): its pgsd_csr_dual_spmm
    takes no wide_blocks argument (the 13th), which a call here drops."""

    def __init__(self, lib):
        p, i = ctypes.c_void_p, ctypes.c_int
        plan = [p, i, p, p, i, i, p, p, i, p, i, p, i]
        for name, head in (("pgsd_csr_dual_spmm", [p] * 6 + [i] * 6),
                           ("pgsd_csr_pair_spmm", [p] * 8 + [i] * 6),
                           ("pgsd_csr_scatter", [p, p, p] + [i] * 7)):
            fn = getattr(lib, name)
            fn.restype = i
            fn.argtypes = head + plan + [p]
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name == "pgsd_csr_dual_spmm":
            return lambda *args: fn(*args[:12], *args[13:])
        return fn


class PreIndexedBuild:
    """A build of scatter_csr.cu from before K1's indexed messages (no
    ``pgsd_csr_scatter_indexed``): ``scatter_csr.bind`` sets the entry's
    types on a stand-in, which raises if called."""

    class _Missing:
        def __call__(self, *args):
            raise RuntimeError("this build has no pgsd_csr_scatter_indexed")

    def __init__(self, lib):
        self._lib = lib
        self.pgsd_csr_scatter_indexed = self._Missing()

    def __getattr__(self, name):
        return getattr(self._lib, name)


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
        lib = ctypes.CDLL(path)
        if kernel == "csr" and not hasattr(lib, "pgsd_csr_block_shape"):
            libs[name] = PlanlessBuild(lib)
        elif kernel == "bsr" and not hasattr(lib, "pgsd_bsr_config"):
            libs[name] = LegacyBsrBuild(lib)
        elif kernel == "csr":
            shape = [ctypes.c_int() for _ in range(3)]
            lib.pgsd_csr_block_shape(*map(ctypes.byref, shape))
            SHAPES[name] = tuple(v.value for v in shape)
            if not hasattr(lib, "pgsd_csr_scatter_indexed"):
                lib = PreIndexedBuild(lib)
            with planned_as(SHAPES[name]):
                libs[name] = (module.bind(lib)
                              if hasattr(lib, "pgsd_csr_dual_tile")
                              else UntiledBuild(lib))
        else:
            libs[name] = module.bind(lib)
    return module, libs


@contextlib.contextmanager
def planned_as(shape):
    """scatter_csr's BLOCK_EDGES, BLOCK_ROWS and WALK_EDGES set to
    ``shape``."""
    names = ("BLOCK_EDGES", "BLOCK_ROWS", "WALK_EDGES")
    saved = [getattr(scatter_csr, k) for k in names]
    for k, v in zip(names, shape):
        setattr(scatter_csr, k, v)
    try:
        yield
    finally:
        for k, v in zip(names, saved):
            setattr(scatter_csr, k, v)


def per_build(libs, fn, plan):
    """{build: call}: ``fn`` itself, or with ``plan`` (rowptr, split)
    ``fn(split)``, rowptr planned anew for a build of another row-block
    shape.  Without a plan, builds of another shape are left out (the
    package's plan would overrun their stages)."""
    own = (scatter_csr.BLOCK_EDGES, scatter_csr.BLOCK_ROWS,
           scatter_csr.WALK_EDGES)
    if plan is None:
        return {n: fn for n in libs if SHAPES.get(n, own) == own}
    rowptr, split = plan
    made = {own: split}
    calls = {}
    for n in libs:
        shape = SHAPES.get(n, own)
        if shape not in made:
            with planned_as(shape):
                made[shape] = scatter_csr.plan_row_split(rowptr)
        calls[n] = functools.partial(fn, made[shape])
    return calls


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


graph_ms = chip_smoke.graph_ms


def in_turns(module, libs, label, fn, extras=(), graphed=(), plan=None):
    """Time ``fn`` under every build (see per_build), in order and then in
    reverse; each (name, fn) of ``extras`` is timed in the same turns.
    The builds, and the extras named in ``graphed``, are also timed as
    replays of a CUDA graph of 20 calls (the third number)."""
    runs = [(n, libs[n], f) for n, f in per_build(libs, fn, plan).items()
            ] + [(n, None, f) for n, f in extras]
    time_runs(module, label, runs, graphed)


def time_runs(module, label, runs, graphed=()):
    """Time each (name, build or None, fn) of ``runs`` in order and then in
    reverse (a build is swapped in behind the wrappers first); the builds,
    and the other runs named in ``graphed``, also as replays of a CUDA
    graph of 20 calls."""
    times = {n: [] for n, _, _ in runs}
    for n, lib, f in runs + runs[::-1]:
        if lib is not None:
            module._lib = lib
        times[n].append(per_call_ms(f))
    for n, lib, f in runs:
        if lib is not None or n in graphed:
            if lib is not None:
                module._lib = lib
            times[n].append(graph_ms(f))
    print(f"{label}: " + ", ".join(
        f"{n} " + "/".join("-" if v is None else f"{v:.4f}" for v in t)
        for n, t in times.items()), flush=True)


def check(module, libs, fn, want, tol, plan=None, row0=0):
    """Hold every build's output against ``want`` at ``tol``; with
    ``plan`` (rowptr, split; its rows at ``row0`` in the output), its cut
    rows at chip_smoke.LIBRARY_TOL, as the hub CSR is held (a hub row's
    compensated float32 pieces are ~1e-5 of its value from float64, which
    ``tol`` misses where the row cancels to near 0).  A build that misses
    is named with its worst element and that row's edges before the
    script stops."""
    bound = tol["atol"] + tol["rtol"] * want.abs()
    if plan is not None:
        cut = plan[1].rows.long() + row0
        bound[cut] = (chip_smoke.LIBRARY_TOL["atol"]
                      + chip_smoke.LIBRARY_TOL["rtol"] * want[cut].abs())
    missed = []
    for n, f in per_build(libs, fn, plan).items():
        module._lib = libs[n]
        excess = (f() - want).abs() - bound
        if not bool((excess > 0).any()):
            continue
        flat = int(excess.argmax())
        row, col = divmod(flat, want.shape[1])
        where = f"row {row} col {col}"
        if plan is not None and 0 <= row - row0 < plan[0].numel() - 1:
            rp = plan[0]
            where += f" ({int(rp[row - row0 + 1] - rp[row - row0])} edges)"
        missed.append(f"{n}: {int((excess > 0).sum())} elements off, the "
                      f"worst by {float(excess.max()):.3e} at {where}, "
                      f"value {float(want.view(-1)[flat]):.4e}")
    if missed:
        raise AssertionError("builds off their plain version: "
                             + "; ".join(missed))


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
    if want("giant_digrac"):
        giant_digrac_cases(module, libs, gen)
    if want("odd"):
        odd_cases(module, libs, gen)
    if want("paths"):
        path_cases(module, libs, gen)
    if want("gather"):
        gather_rate(gen)


def gather_rate(gen):
    """The card's rate of row gathers from L2, measured without the
    kernels on a table that fits in L2 (131,072 rows, the giant graph's
    hot table: 32 MiB at W=64 f32): ``torch.nn.functional.embedding_bag``
    (mode "sum") gathers 2^22 random rows in bags of 32, so it writes
    1/32 of what it gathers, and ``torch.index_select`` gathers 2^16 rows
    into an output that L2 holds too.  Gathered bytes over device time (20
    calls back to back): library calls, so a floor under the rate that a
    K1/K2 call's gathers (edges x W x element size) can meet when its
    table stays in L2, not its ceiling."""
    rows, n_idx, bag = 131_072, 1 << 22, 32
    for width, dt in ((64, torch.float32), (32, torch.float32),
                      (64, torch.bfloat16)):
        table = torch.randn(rows, width, device=DEV, generator=gen).to(dt)
        idx = torch.randint(0, rows, (n_idx,), device=DEV, generator=gen)
        offsets = torch.arange(0, n_idx, bag, device=DEV)
        # index_select of 2^16 rows into one output that L2 also holds
        # (8-16 MiB, rewritten each call)
        few = idx[:1 << 16]
        buf = torch.empty(len(few), width, device=DEV, dtype=dt)
        mb = table.numel() * table.element_size() / 2**20
        for what, n, fn in (
                (f"embedding_bag in bags of {bag}", n_idx,
                 lambda: torch.nn.functional.embedding_bag(
                     idx, table, offsets, mode="sum")),
                ("index_select into an L2-sized output", len(few),
                 lambda: torch.index_select(table, 0, few, out=buf))):
            ms = per_call_ms(fn)
            gathered = n * width * table.element_size()
            print(f"L2 gather rate: {what}, {n} rows of a {rows}x{width} "
                  f"{str(dt)[6:]} table ({mb:.0f} MiB): {ms:.4f} ms, "
                  f"{gathered / ms / 1e9:.3f} TB/s gathered", flush=True)


def accum_turns(module, libs, gen, D, width, label, single, library):
    """K2 on block 0 of ``D`` (a dual, or a ``single_view``) at ``width``,
    f32 and bf16, into a zero output; with ``library`` one cuSPARSE
    ``addmm`` a value array (f32) in the same turns."""
    f32, bf16 = torch.float32, torch.bfloat16
    b = D.blocks[0]
    table = D.hot_ids.numel() if D.hot_blocks else D.num_cols
    rows = b.rowptr.numel() - 1
    fa = width if single else width // 2
    s = slice(b.e0, b.e1)
    out = torch.zeros(D.num_nodes, width, device=DEV)
    for dt in (f32, bf16):
        x = torch.randn(table, width, device=DEV, generator=gen).to(dt)
        args = (b.rowptr, D.col[s], D.val_a[s], D.val_b[s], x, fa)
        check(module, libs, lambda split: scatter_csr.csr_dual_spmm_accum(
            *args, out.clone(), b.row0, split),
            scatter_csr.csr_dual_spmm_accum_plain(*args, out, b.row0),
            chip_smoke.F32_TOL if dt == f32 else chip_smoke.BF16_TOL,
            plan=(b.rowptr, b.split), row0=b.row0)

        def k2(split, args=args):
            return scatter_csr.csr_dual_spmm_accum(*args, out, b.row0, split)

        extras = ()
        if dt == f32 and library:
            rp, cl = b.rowptr.long(), args[1].long()
            o = out[b.row0:b.row0 + rows]
            mats = [torch.sparse_csr_tensor(rp, cl, v, size=(rows, table))
                    for v in ((args[2],) if single else args[2:4])]
            if single:
                lib = [(mats[0], o.contiguous(), x)]
            else:
                lib = [(m, o[:, h].contiguous(), x[:, h].contiguous())
                       for m, h in zip(mats, (slice(0, fa), slice(fa, None)))]
            extras += ((f"{len(lib)}x addmm", lambda lib=lib: [
                torch.addmm(oo, m, xx) for m, oo, xx in lib]),)
        in_turns(module, libs,
                 f"K2 {label} block 0 {'W' if single else '2F'}={width} "
                 f"{str(dt)[6:]} (rows={rows} nnz={b.e1 - b.e0})",
                 k2, extras, graphed=[n for n, _ in extras],
                 plan=(b.rowptr, b.split))


def giant_digrac_cases(module, libs, gen):
    """K2 on block 0 of the giant DIGRAC operators (chip_smoke.py phase
    14's cases), with one cuSPARSE ``addmm`` a value array (f32) in the
    same turns."""
    script = chip_smoke.giant_digrac_script()
    g = chip_smoke.GIANT
    n = g["nodes"]
    row, col = script.powerlaw_digraph(n, g["edges"], g["alpha"],
                                       seed=chip_smoke.GIANT_DIGRAC["seed"])
    ei = np.vstack([row, col])
    w = np.ones(len(row), np.float32)
    for form, cases in chip_smoke.GIANT_DIGRAC_CASES.items():
        ops = dict(script.named_operators(*script.operators(
            ei, w, n, form == "fused", torch.device(DEV), {})))
        for label, width in cases:
            single = form == "pair"
            d = script.kernel_view(ops[label])
            D = chip_smoke.single_view(d) if single else d
            accum_turns(module, libs, gen, D, width, f"giant digrac {label}",
                        single, library=True)
        del ops


def dual_turns(module, libs, gen, D, width, label, single):
    """K1 on flat ``D`` at ``width``, f32, against its plain version, then
    timed in turns."""
    fa = width if single else width // 2
    x = torch.randn(D.num_cols, width, device=DEV, generator=gen)
    args = (D.rowptr, D.col, D.val_a, D.val_b, x, fa)
    plan = (D.rowptr, D.row_split)
    check(module, libs,
          lambda split: scatter_csr.csr_dual_spmm(*args, split),
          scatter_csr.csr_dual_spmm_plain(*args), chip_smoke.F32_TOL, plan)
    in_turns(module, libs,
             f"K1 {label} {'W' if single else '2F'}={width} float32 "
             f"(rows={D.rowptr.numel() - 1} nnz={D.col.numel()})",
             lambda split: scatter_csr.csr_dual_spmm(*args, split),
             plan=plan)


def path_cases(module, libs, gen):
    """The other K1/K2 cases that PERF.md times on the paths: K1 on
    msgnn_link's flat operator (chip_smoke.py phase 7, N=9000) at 2F=8 and
    128; K2 on block 0 of DGCN's streamed A_in at W=32 (phase 8); K1 on
    the bench SGCN dual at 2F=128 and 64 (phase 9); K1 on the bench DiGCL
    operator at W=128 and 64 (phase 11)."""
    import importlib

    from pytorch_geometric_signed_directed_tpu_torch.experiments import (
        EXPERIMENTS)
    from pytorch_geometric_signed_directed_tpu_torch.graph import (
        directed_features_in_out, gcn_norm_propagator)
    from pytorch_geometric_signed_directed_tpu_torch.nn.signed.sgcn import (
        prepare_sgcn_inputs)

    mod = importlib.import_module(
        "pytorch_geometric_signed_directed_tpu_torch.experiments."
        + EXPERIMENTS["msgnn_link"][0])
    argv = ["--dataset", "synthetic", "--num_nodes",
            str(chip_smoke.EXPERIMENT_N), "--device", DEV]
    D = mod.build_inputs(mod.parser().parse_args(argv), DEV).lap.dual
    for width in (8, 128):
        dual_turns(module, libs, gen, D, width, "msgnn_link flat", False)
    del D
    n, ei, w, _, _, _ = chip_smoke.digcn_graph()
    _, e_in, w_in, _, _ = directed_features_in_out(ei, n, w)
    A_in = chip_smoke.single_view(chip_smoke.csr_of(
        gcn_norm_propagator(e_in, w_in, n, device=DEV)))
    accum_turns(module, libs, gen, A_in, chip_smoke.DGCN_HIDDEN,
                "dgcn A_in", True, library=False)
    del A_in
    c = chip_smoke.BENCH_SGCN
    rng = np.random.default_rng(0)
    m = c["e_pos"] + c["e_neg"]
    edge_s = np.column_stack([
        rng.integers(0, c["nodes"], m), rng.integers(0, c["nodes"], m),
        np.concatenate([np.ones(c["e_pos"]), -np.ones(c["e_neg"])])
    ]).astype(np.int64)
    emb = rng.standard_normal((c["nodes"], c["dim"])).astype(np.float32)
    D = prepare_sgcn_inputs(c["nodes"], edge_s, in_dim=c["dim"],
                            init_emb=emb, fused=True, device=DEV)[3]
    for width in (2 * c["dim"], c["dim"]):
        dual_turns(module, libs, gen, D, width, "bench sgcn dual", False)
    del D
    c = chip_smoke.BENCH_DIGCL
    edge_index, w, _, _ = chip_smoke.slice_graph(c["nodes"], c["avg_deg"], 0)
    P = chip_smoke.single_view(chip_smoke.csr_of(gcn_norm_propagator(
        edge_index, w, c["nodes"], mode="auto", device=DEV)))
    for width in (128, 64):
        dual_turns(module, libs, gen, P, width, "bench digcl", True)


def odd_cases(module, libs, gen):
    """``csr_scatter_sum`` at widths off a multiple of 4 on chip_smoke.py
    phase 10's CSRs, and on long_row_csr() at W=1, 5, 17, 21 and 34 and
    from a base off 16 bytes at W=64, with ``torch.segment_reduce`` in the
    same turns."""
    cases = [(label, p.rowptr, p.split, width, chip_smoke.graph_text(p), 0)
             for label, p, width in attention_csrs()]
    rowptr, split, text = long_row_csr()
    cases += [("long rows", rowptr, split, w, text, 0)
              for w in (1, 5, 17, 21, 34)]
    cases.append(("long rows unaligned", rowptr, split, 64, text, 1))
    for label, rowptr, split, width, text, shift in cases:
        e = int(rowptr[-1])
        flat = torch.randn(e * width + shift, device=DEV, generator=gen)
        msgs = flat[shift:].view(e, width)

        def k1(split, msgs=msgs, rowptr=rowptr):
            return scatter_csr.csr_scatter_sum(rowptr, msgs, split)

        check(module, libs, k1,
              scatter_csr.csr_scatter_sum_plain(rowptr, msgs),
              chip_smoke.F32_TOL, (rowptr, split))
        offsets = rowptr.long()
        extras = (("segment_reduce", lambda msgs=msgs, offsets=offsets:
                   torch.segment_reduce(msgs, "sum", offsets=offsets,
                                        axis=0)),)
        in_turns(module, libs, f"K1 scatter {label} W={width} float32 "
                 f"({text})", k1, extras, graphed=("segment_reduce",),
                 plan=(rowptr, split))


def long_row_csr():
    """A power-law CSR with a tail of uncut rows: 8,192 rows of 40 to 1,024
    edges (log-uniform) among 24,576 rows of 1 to 39 (Zipf), in a random
    order; its rowptr, plan and a line of text."""
    rng = np.random.default_rng(14)
    lengths = np.concatenate([
        np.exp(rng.uniform(np.log(40), np.log(1024), 8192)).astype(np.int64),
        np.minimum(rng.zipf(2.0, 24_576), 39)])
    lengths = lengths[rng.permutation(len(lengths))]
    rowptr = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(lengths)]).astype(np.int32)).to(DEV)
    return (rowptr, scatter_csr.plan_row_split(rowptr),
            f"rows={len(lengths)} nnz={int(lengths.sum())} "
            f"longest={int(lengths.max())}")


def attention_csrs():
    """(label, ScatterPlan, width) of chip_smoke.py phase 10's cases: the
    bench SNEA and epinions-size SNEA graphs (g_pos at W=17, g_cat at
    34), the bench SiGAT motif 0 at W=21 and its motif stack by
    destination (W=21 and 1) and by source (W=21)."""
    from pytorch_geometric_signed_directed_tpu_torch.nn.signed import (
        prepare_sigat_inputs, snea_graphs, split_signed_edges)
    from pytorch_geometric_signed_directed_tpu_torch.spectral.features \
        import create_spectral_features

    out = []
    for name, c in (("bench snea", chip_smoke.BENCH_SNEA),
                    ("snea epinions", chip_smoke.SNEA_EPINIONS)):
        n, rng = c["nodes"], np.random.default_rng(0)
        pos = np.vstack([rng.integers(0, n, c["e_pos"]),
                         rng.integers(0, n, c["e_pos"])])
        neg = np.vstack([rng.integers(0, n, c["e_neg"]),
                         rng.integers(0, n, c["e_neg"])])
        g_pos, _, g_cat = snea_graphs(pos, neg, n, device=DEV)
        half = c["dim"] // 2
        out += [(f"{name} g_pos", g_pos.plan, 1 + half),
                (f"{name} g_cat", g_cat.plan, 2 + 2 * half)]
    c = chip_smoke.BENCH_MOTIF
    n, dim, rng = c["nodes"], c["dim"], np.random.default_rng(0)
    m = c["e_pos"] + c["e_neg"]
    edges = np.column_stack([
        rng.integers(0, n, m), rng.integers(0, n, m),
        np.concatenate([np.ones(c["e_pos"]), -np.ones(c["e_neg"])])
    ]).astype(np.int64)
    emb = create_spectral_features(*split_signed_edges(edges), n, dim)
    lists = prepare_sigat_inputs(n, edges, in_dim=dim, init_emb=emb,
                                 device=DEV)[3]
    stack = prepare_sigat_inputs(n, edges, in_dim=dim, init_emb=emb,
                                 fused=True, device=DEV)[3]
    return out + [("sigat motif 0", lists[0].plan, dim + 1),
                  ("sigat stack by destination", stack.g.plan, dim + 1),
                  ("sigat stack by source", stack.src_plan, dim + 1),
                  ("sigat stack by destination", stack.g.plan, 1)]


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


@contextlib.contextmanager
def ctas_per_sm(c):
    """bsr_spmm's CTAS_PER_SM set to ``c``."""
    saved = bsr_spmm.CTAS_PER_SM
    bsr_spmm.CTAS_PER_SM = c
    try:
        yield
    finally:
        bsr_spmm.CTAS_PER_SM = saved


def bsr_turns(module, libs, gen, op, width, label, ctas):
    """K5 on ``op`` at ``width`` under every build, held against its plain
    version, then timed in turns with the dense ``torch.matmul`` and
    ``torch.sparse.mm`` on a BSR tensor; each build under the operator's
    plan and under a plan of each CTAS_PER_SM in ``ctas``."""
    x = torch.randn(op.num_cols, width, device=DEV, generator=gen)
    args = (op.blocks, op.block_rowptr, op.block_cols, x, op.num_rows)
    splits = {"": op.split}
    for c in ctas:
        with ctas_per_sm(c):
            splits[f" ctas={c}"] = bsr_spmm.plan_block_split(
                op.block_rowptr, op.blocks.shape[0], bsr_spmm.sm_count(DEV))
    for split in splits.values():
        check(module, libs, lambda split=split: bsr_spmm.bsr_matmul(
            *args, split), bsr_spmm.bsr_matmul_plain(*args),
            chip_smoke.F32_TOL)
    dense = chip_smoke.dense_of(op)
    n_bc = -(-op.num_cols // 128)
    x_pad = torch.zeros((n_bc * 128, width), device=DEV)
    x_pad[:op.num_cols] = x
    A = torch.sparse_bsr_tensor(
        op.block_rowptr.long(), op.block_cols.long(), op.blocks,
        size=(dense.shape[0], n_bc * 128))
    extras = (("dense matmul", lambda: torch.matmul(dense, x)),
              ("sparse.mm BSR", lambda: torch.sparse.mm(A, x_pad)))
    runs = [(n + tag, libs[n],
             lambda split=split: bsr_spmm.bsr_matmul(*args, split))
            for n in libs for tag, split in splits.items()]
    time_runs(module, f"K5 {label} W={width} (blocks="
              f"{op.blocks.shape[0]} pieces={op.split.pieces.shape[0]})",
              runs + [(n, None, f) for n, f in extras],
              graphed=[n for n, _ in extras])


def bsr_cases(module, libs, gen, want, ctas=()):
    """The bsr cell's operator (chip_smoke.py's N=8192 graph) and its
    transpose at W=2 and 32, the operator at W=1, 8 and 64, and shard 0
    of its four-shard partition (phase 13) at W=32."""
    from pytorch_geometric_signed_directed_tpu_torch import parallel

    cfg = chip_smoke.BSR_GRAPH
    ei, w, _, _ = chip_smoke.slice_graph(cfg["nodes"], cfg["avg_deg"],
                                         seed=cfg["seed"])
    lap = magnet_propagators(ei, w, q=0.25, num_nodes=cfg["nodes"],
                             mode="bsr", device=DEV)
    B = lap.re.bsr
    for width in (2, 32):
        for name, op in (("bsr fwd", B), ("bsr bwd", B.transposed)):
            bsr_turns(module, libs, gen, op, width, name, ctas)
    for width in (1, 8, 64):
        bsr_turns(module, libs, gen, B, width, "bsr fwd", ctas)
    shard = parallel.shard_magnet_laplacian(
        lap, chip_smoke.four_shards()).re.sharded.shards[0]
    bsr_turns(module, libs, gen, shard, 32, "sharded bsr shard 0", ctas)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    args = sys.argv[1:]
    if not args or args[0] not in KERNELS:
        sys.exit(f"usage: {sys.argv[0]} {{{','.join(KERNELS)}}} "
                 f"[--only group,...] [--ctas a,b] name=flags ...")
    kernel, args = args[0], args[1:]
    only, ctas = None, ()
    if args[:1] == ["--only"]:
        only, args = set(args[1].split(",")), args[2:]
    if args[:1] == ["--ctas"]:
        ctas, args = tuple(int(c) for c in args[1].split(",")), args[2:]
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
    cases = {"csr": csr_cases, "bsr": functools.partial(bsr_cases,
                                                         ctas=ctas),
             "sddmm": sddmm_cases}
    cases[kernel](module, libs, gen,
                  lambda group: only is None or group in only)


if __name__ == "__main__":
    main()
