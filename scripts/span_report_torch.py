#!/usr/bin/env python3
"""The port's spans over one cell of ``port_bench`` on the card: where an
epoch's device time and the set-up's seconds go, by the port's own
layers, and what the spans cost when on.

Builds the cell as ``port_bench/harness.py`` does (the same inputs,
weights, driver and warm-up from ``--seed``), with the port's spans
(``instrument``) on from the start, so the set-up's ``pgsd.prep.*``
and ``pgsd.train.*`` spans are recorded and MagNet's capture keeps its
span table.  Then, on the warm cell:

* the cost of the spans: ``dispatch_ms`` (each epoch dispatched into an
  empty queue) and ``train_edges_per_s`` (dispatched 3 ahead for
  ``--seconds``), with the spans off and on, in turns off, on, on, off;
* two traced stretches of ``port_bench``'s length, spans off then on,
  read by ``port_bench``'s own readers (``idle_share``, ``mfu``,
  ``spmm_roofline``) and, the second, by ``profiling.attribute``: each
  device operation under the port span around its launch (eager) or its
  capture node (replayed).

The kernel wrappers' launches an epoch (``launches_per_epoch``: the
cell program's ``counters()`` over the stretch of epochs dispatched one
at a time).
From the attribution (per traced epoch): every span's count and device
milliseconds (operations whose innermost span it is); the share of
device time under some span; ``apply_roofline`` (the least time of each
``pgsd.spmm.apply`` span's apply, ``port_bench.cost.apply_bound_s``
from its own attributes, over the device time of every operation inside
those spans); ``apply_overhead_ms`` (inside an apply, outside every
``pgsd.kernel.*`` span); ``layers_ms`` and ``loss_ms`` (innermost
``pgsd.nn.*`` / ``pgsd.loss.*``); ``layout_s`` and ``optimizer_build_s``
(host seconds of those set-up spans) and ``prep_spans_s`` (host seconds
of each ``pgsd.prep.*`` span: the layout, the spectral features, the
motif lists); and the largest device operations of each span.  The
traced stretches are read by ``idle_share``, ``mfu`` and the cell's own
``device_trace`` metrics.  Prints one line per span and one JSON line,
and writes the JSON to ``--out`` when given.

Run from the root of the checkout, on a card:

    python3 scripts/span_report_torch.py --workload <cell> --seed <n>
        [--seconds 8] [--out chiprun_out/spans.json]

``--device cpu --tiny`` runs the same steps on the CPU on a graph of
2,000 nodes (the kernels' plain versions: no device operation, so no
device number), to try the script.
"""
import argparse
import json
import math
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from port_bench import cost, harness, trace  # noqa: E402
from port_bench.reference import common as ref_common  # noqa: E402
from pytorch_geometric_signed_directed_tpu_torch import (  # noqa: E402
    instrument)
from pytorch_geometric_signed_directed_tpu_torch.train import (  # noqa: E402
    profiling)


# ``--tiny``: the traffic's size keys by generator (2,000 nodes)
TINY = {"signed_powerlaw": dict(nodes=2000, positive=8000, negative=2000)}
TINY_DEFAULT = dict(nodes=2000, draws=8000)


def seconds_in(records, name: str) -> float:
    """Host seconds of the span records named ``name``."""
    return sum(r.t1 - r.t0 for r in records if r.name == name) / 1e9


def _ms(op) -> float:
    return (op.end - op.start) / 1e3


def quantities(att: profiling.Attribution, records, epochs: int) -> dict:
    """The span metrics of a traced stretch of ``epochs`` epochs
    (``att``) and of the set-up's span ``records``."""
    inside = [op for op in att.ops
              if any(s.name == "spmm.apply" for s in op.spans)]
    spent = sum(_ms(op) for op in inside) / 1e3
    need = sum(cost.apply_bound_s(cost.Apply(
        s.attr("rows"), s.attr("cols"), s.attr("nnz"), s.attr("values"),
        s.attr("width"), s.attr("elem"))) for s in att.spans
        if s.name == "spmm.apply")
    total = sum(_ms(op) for op in att.ops)

    def innermost(prefix):
        return sum(_ms(op) for op in att.ops if op.innermost is not None
                   and op.innermost.name.startswith(prefix)) / epochs

    return dict(
        apply_roofline=100.0 * need / spent if spent > 0 else None,
        apply_overhead_ms=sum(
            _ms(op) for op in inside
            if not any(s.name.startswith("kernel.") for s in op.spans))
        / epochs,
        layers_ms=innermost("nn."),
        loss_ms=innermost("loss."),
        layout_s=seconds_in(records, "prep.layout"),
        optimizer_build_s=seconds_in(records, "train.optimizer_build"),
        prep_spans_s={name: seconds_in(records, name) for name in sorted(
            {r.name for r in records if r.name.startswith("prep.")})},
        covered=(sum(_ms(op) for op in att.ops if op.spans) / total
                 if total > 0 else None),
        device_ms_per_epoch=total / epochs)


def top_ops(att: profiling.Attribution, epochs: int, limit: int = 40):
    """The largest (innermost span, device operation) pairs: device ms an
    epoch."""
    by = {}
    for op in att.ops:
        key = (op.innermost.name if op.innermost else "-", op.name[:200])
        by[key] = by.get(key, 0.0) + _ms(op) / epochs
    return sorted(([s, n, ms] for (s, n), ms in by.items()),
                  key=lambda r: -r[2])[:limit]


def _traced(prog, stamps, k, families, spans_on):
    from torch.profiler import ProfilerActivity, profile

    instrument.set_tracing(spans_on)
    acts = [ProfilerActivity.CPU]
    if stamps.cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        epochs, _, epoch_s, _ = harness.drive(prog, stamps, math.inf, k,
                                              spans=True)
    instrument.set_tracing(False)
    return prof, trace.Trace.from_profile(prof, families), epochs, epoch_s


def _bench_metrics(prog, tr, epochs, epoch_s, calls, names):
    run = harness.Run(trace=tr, traced_epochs=epochs, traced_epoch_s=epoch_s,
                      applies_per_epoch=prog.applies_per_epoch(),
                      flops_per_epoch=prog.flops_per_epoch(),
                      calls_per_epoch=calls)
    return {m: harness.load_module(ROOT, "metrics", m).read(run)
            for m in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("span_report: needs a CUDA card", file=sys.stderr)
        return 2
    instrument.set_tracing(True)
    cell = harness.Cell.find(ROOT, args.workload)
    if args.tiny:
        cell.traffic.update(TINY.get(cell.traffic["generator"],
                                     TINY_DEFAULT))
    metrics = ["idle_share", "mfu"] + [
        m["name"] for m in cell.per_layer
        if m["source"] == "device_trace" and m["name"] not in
        ("idle_share", "mfu")]
    stamps = harness.Stamps(device)
    seed = args.seed % (1 << 63)
    config = cell.config
    graph = harness.load_module(ROOT, "gen", cell.traffic["generator"]
                                ).generate(cell.traffic, seed, device)
    inputs = harness.task_inputs(config, graph, seed)
    driver = harness.load_module(ROOT, "drivers", config["model"])
    reference = harness.load_module(ROOT, "reference", config["model"])
    params0 = ref_common.draw_params(reference.param_spec(config), seed,
                                     device)
    prog = driver.Program(config, graph, inputs, device)
    t0 = time.perf_counter()
    prog.prepare()
    stamps.sync()
    prep_s = time.perf_counter() - t0
    prog.build({k: v.clone() for k, v in params0.items()}, harness.CAPACITY)
    prog.first_steps()
    _, _, warm, _ = harness.drive(prog, stamps, harness.WARMUP_S,
                                  harness.CAPACITY)
    setup_records = instrument.drain()
    table = getattr(getattr(prog, "run", None), "span_table", None)
    epoch_est = statistics.median(warm)
    k = int(min(max(harness.TRACE_S / max(epoch_est, 1e-9),
                    harness.TRACE_EPOCHS[0]), harness.TRACE_EPOCHS[1]))
    edges = int(graph["edge_index"].shape[1])

    # the spans' cost, in turns off, on, on, off
    cost_rows = []
    for on in (False, True, True, False):
        instrument.set_tracing(on)
        _, _, _, d_ms = harness.drive(prog, stamps, math.inf, k, ahead=0)
        n, wall, _, _ = harness.drive(prog, stamps, args.seconds,
                                      harness.CAPACITY)
        instrument.set_tracing(False)
        instrument.drain()
        cost_rows.append(dict(spans=on, dispatch_ms=statistics.fmean(d_ms),
                              train_edges_per_s=edges * n / wall))

    before = prog.counters()
    harness.drive(prog, stamps, math.inf, k, ahead=0)
    counted = {n: v - before.get(n, 0) for n, v in prog.counters().items()}
    calls = prog.calls_per_epoch(counted, k)
    families = trace.load_families(ROOT)
    _, tr_off, e_off, s_off = _traced(prog, stamps, k, families, False)
    bench_off = _bench_metrics(prog, tr_off, e_off, s_off, calls, metrics)
    prof, tr_on, e_on, s_on = _traced(prog, stamps, k, families, True)
    bench_on = _bench_metrics(prog, tr_on, e_on, s_on, calls, metrics)
    instrument.drain()
    att = profiling.attribute(prof, table)
    del prof

    out = dict(workload=args.workload, seed=args.seed,
               card=(torch.cuda.get_device_name(device) if stamps.cuda
                     else "cpu"),
               power_limit=harness.power_limit() if stamps.cuda else None,
               traced_epochs=e_on,
               prep_s=prep_s, calls_per_epoch=calls,
               attends_per_epoch=(counted["attends"] / k
                                  if "attends" in counted else None),
               launches_per_epoch={n: v / k for n, v in counted.items()
                                   if v and n != "attends"},
               applies_per_epoch=len(prog.applies_per_epoch()),
               table_rows=len(table.rows) if table else None,
               table_nodes=table.nodes if table else None,
               bench_spans_off=bench_off, bench_spans_on=bench_on,
               cost=cost_rows)
    if att is not None:
        out.update(quantities(att, setup_records, e_on),
                   replays=att.replays,
                   spans=att.by_span(e_on), top=top_ops(att, e_on))
        for name, (count, ms) in sorted(out["spans"].items(),
                                        key=lambda kv: -kv[1][1]):
            print(f"span pgsd.{name}: {count:g} an epoch, {ms:.4f} device "
                  f"ms an epoch", file=sys.stderr)
    for r in cost_rows:
        print(f"spans {'on ' if r['spans'] else 'off'}: dispatch_ms "
              f"{r['dispatch_ms']:.4f}, train_edges_per_s "
              f"{r['train_edges_per_s']:.6g}", file=sys.stderr)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
