"""One run of one cell: set-up, the measured window (or a traced
stretch), the check against the plain reference, and the result line.

The cell is found by name: ``BENCHMARK.json``'s workload names its
configuration (``configs/<config>.json``, whose ``model`` names
``drivers/<model>.py`` and ``reference/<model>.py``) and its traffic
(``traffic/<traffic>.json``, whose ``generator`` names
``gen/<generator>.py``); the check's limits are ``limits/<cell>.json``;
each metric is read by ``metrics/<name>.py`` and each kernel family is
named by ``kernels/<family>.json``.

The window: epochs are dispatched closed loop, at most ``AHEAD`` epochs
ahead of the device, with no read of a device value; it starts at the
first dispatch and ends at a synchronize once ``--seconds`` have passed
on the host clock.  CUDA events recorded between epochs give each
epoch's time, read once after the window.
"""
import argparse
import gc
import importlib.util
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from port_bench import check, trace
from port_bench.trace import Trace
from port_bench.reference import common as ref_common

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "pytorch_geometric_signed_directed_tpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
AHEAD = 3                 # epochs in flight while the next is dispatched
CAPACITY = 1 << 18        # epochs a process may dispatch
WARMUP_S = 0.5            # steady epochs after the first three
TRACE_S = 1.0             # the traced stretch, and the stretch before it
TRACE_EPOCHS = (3, 50)    # ... in epochs, at least and at most
STEPS_CHECKED = 3


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(root: str, kind: str, name: str):
    """``port_bench/<kind>/<name>.py`` as a module."""
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = os.path.join(root, "port_bench", kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"port_bench.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def find(cls, root: str, workload: str) -> "Cell":
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        w = cells[workload]
        for key in ("config", "traffic"):
            if not NAME.match(w[key]):
                raise ValueError(f"bad {key} name {w[key]!r}")
        config = load_json(os.path.join(root, "port_bench", "configs",
                                        w["config"] + ".json"))
        traffic = load_json(os.path.join(root, "port_bench", "traffic",
                                         w["traffic"] + ".json"))

        def mine(ms):
            return [m for m in ms if workload in m.get("workloads",
                                                       [workload])]

        return cls(workload, int(w["chips"]), config, traffic,
                   mine(bench["end_to_end"]), mine(bench["per_layer"]))


@dataclass
class Run:
    """What one run read: the metric readers' input."""
    edges: int = 0
    setup_s: float = 0.0
    prep_s: float = 0.0
    window_epochs: int = 0
    window_s: float = 0.0
    epoch_s: List[float] = field(default_factory=list)
    dispatch_ms: List[float] = field(default_factory=list)
    calls_per_epoch: Optional[float] = None
    applies_per_epoch: list = field(default_factory=list)
    flops_per_epoch: float = 0.0
    trace: Optional[Trace] = None
    traced_epochs: int = 0
    traced_epoch_s: List[float] = field(default_factory=list)


class Stamps:
    """Marks on the device's stream (CUDA events) or, on the CPU, on the
    host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def wait(self, m) -> None:
        if self.cuda:
            m.synchronize()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def seconds(self, a, b) -> float:
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a


def _span(name: str, on: bool):
    return torch.profiler.record_function(name) if on else _Nothing()


class _Nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def drive(prog, stamps: Stamps, seconds: float, cap: int, spans=False,
          ahead: int = AHEAD):
    """Dispatch epochs until ``seconds`` have passed or ``cap`` epochs are
    out, with at most ``ahead`` epochs still on the device when the next
    is dispatched; then synchronize.  Returns (epochs, wall seconds, each
    epoch's seconds, each dispatch's host ms)."""
    marks = [stamps.mark()]
    dispatch_ms = []
    t0 = time.perf_counter()
    n = 0
    while n < cap:
        if n - ahead >= 1:
            with _span("port_bench.wait", spans):
                stamps.wait(marks[n - ahead])
        with _span("port_bench.dispatch", spans):
            h0 = time.perf_counter()
            prog.dispatch()
            dispatch_ms.append((time.perf_counter() - h0) * 1e3)
        marks.append(stamps.mark())
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    with _span("port_bench.sync", spans):
        stamps.sync()
    wall = time.perf_counter() - t0
    return n, wall, [stamps.seconds(marks[i], marks[i + 1])
                     for i in range(n)], dispatch_ms


def task_inputs(config: dict, graph: dict, seed: int) -> dict:
    """Labels (the traffic's), the seed of the dropout masks (its own
    stream of the seed, apart from the parameters') and, where the
    configuration splits the nodes, random train / validation / test
    masks [3, N] from the seed."""
    dropout_seed = np.random.SeedSequence([seed, 3]).generate_state(
        1, np.uint64)[0]
    out = {"labels": graph.get("labels"),
           "dropout_seed": int(dropout_seed) >> 1}
    if "split" in config:
        n = graph["num_nodes"]
        rng = np.random.default_rng(np.random.SeedSequence([seed, 2]))
        cuts = np.cumsum([int(f * n) for f in config["split"][:-1]])
        masks = np.zeros((3, n), np.float32)
        for k, part in enumerate(np.split(rng.permutation(n), cuts)):
            masks[k, part] = 1.0
        out["masks"] = masks
    return out


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0].strip() if out else None


def limits_for(cell: Cell, root: str = ROOT) -> dict:
    """The check's limits of the cell: ``limits/<cell>.json``."""
    return load_json(os.path.join(root, "port_bench", "limits",
                                  cell.name + ".json"))["limits"]


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             started: float, root: str = ROOT) -> dict:
    """One run of ``cell``; ``started`` is the process's start on the
    ``time.perf_counter`` clock.  Returns (the result line as a dict, the
    run's readings, notes for the log)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    stamps = Stamps(device)
    seed = int(seed) % (1 << 63)
    config, traffic = cell.config, cell.traffic
    marks = {"start": time.perf_counter() - started}
    graph = load_module(root, "gen", traffic["generator"]).generate(
        traffic, seed, device)
    marks["inputs"] = time.perf_counter() - started
    inputs = task_inputs(config, graph, seed)
    driver = load_module(root, "drivers", config["model"])
    reference = load_module(root, "reference", config["model"])
    params0 = ref_common.draw_params(reference.param_spec(config), seed,
                                     device)
    run = Run(edges=int(graph["edge_index"].shape[1]))
    prog = driver.Program(config, graph, inputs, device)

    t0 = time.perf_counter()
    prog.prepare()
    stamps.sync()
    run.prep_s = time.perf_counter() - t0
    marks["prepared"] = time.perf_counter() - started
    prog.build({k: v.clone() for k, v in params0.items()}, CAPACITY)
    marks["built"] = time.perf_counter() - started
    prog.first_steps()
    marks["first_steps"] = time.perf_counter() - started
    _, _, warm, _ = drive(prog, stamps, WARMUP_S, CAPACITY)
    marks["warm"] = time.perf_counter() - started
    epoch_est = statistics.median(warm)
    left = CAPACITY - prog.dispatched - 1

    if not traced:
        run.setup_s = time.perf_counter() - started
        run.window_epochs, run.window_s, run.epoch_s, _ = drive(
            prog, stamps, seconds, left)
        attempted = run.window_epochs
    else:
        k = int(min(max(TRACE_S / max(epoch_est, 1e-9), TRACE_EPOCHS[0]),
                    TRACE_EPOCHS[1]))
        # each dispatch into an empty queue: the host's own time an epoch
        before = prog.counters()
        _, _, _, run.dispatch_ms = drive(prog, stamps, math.inf, k, ahead=0)
        counted = {n: v - before.get(n, 0)
                   for n, v in prog.counters().items()}
        run.calls_per_epoch = prog.calls_per_epoch(counted, k)
        run.applies_per_epoch = prog.applies_per_epoch()
        run.flops_per_epoch = prog.flops_per_epoch()
        if cuda:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run.traced_epochs, _, run.traced_epoch_s, _ = drive(
                    prog, stamps, math.inf, k, spans=True)
            run.trace = Trace.from_profile(
                prof, trace.load_families(root))
            del prof
        attempted = k

    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    got = host_readings(prog.readings())
    prog.release()
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = reference_readings(reference, config, graph, inputs, params0,
                              device)[0]
    ref_s = time.perf_counter() - t0
    correct, rows = check.judge(check.gaps(got, want),
                                limits_for(cell, root))

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = load_module(root, "metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": 0, "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.span_s
        result["breakdown"] = run.trace.breakdown()
    result["check"] = rows
    return result, run, dict(reference_s=ref_s, marks=marks, program=got,
                             reference=want)


def reference_readings(reference, config, graph, inputs, params0, device,
                       faults=(None,)):
    """The plain reference's readings of the first STEPS_CHECKED steps, a
    list of one dict for each of ``faults`` (None: the sound
    reference)."""
    prepared = reference.prepare(config, graph, device)
    out = []
    for fault in faults:
        losses, grad1, change = reference.train(
            config, prepared, inputs, params0, STEPS_CHECKED, fault=fault)
        out.append(host_readings(dict(losses=losses, grad1=grad1,
                                      change=change)))
    return out


def host_readings(r: dict) -> dict:
    """Readings with their tensors as float64 in host memory."""
    return dict(r, **{k: {name: v.detach().to("cpu", torch.float64)
                          for name, v in r[k].items()}
                      for k in ("grad1", "change")})


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def main(argv=None, started: float = None) -> int:
    started = time.perf_counter() if started is None else started
    ap = argparse.ArgumentParser(prog="python3 port_bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell.find(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"port_bench: {args.workload} needs {cell.chips} CUDA "
            f"device(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f": no result")
        return 2
    result, run, notes = run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), "cuda", started)
    found = forbidden_modules()
    if found:
        log(f"port_bench: the process holds {found} after the window: no "
            f"result")
        return 3
    pl = power_limit()
    result["device"]["power_limit"] = pl
    if args.trace:
        log(f"traced {run.traced_epochs} epochs; prep {run.prep_s:.3f} s")
    else:
        p = sorted(run.epoch_s)
        log(f"window: {run.window_epochs} epochs in {run.window_s:.4f} s "
            f"(epoch_ms_p95 over {len(p)} epochs; median "
            f"{1e3 * statistics.median(p):.4f} ms); setup {run.setup_s:.3f} "
            f"s (prep {run.prep_s:.3f} s)")
    log(f"card {result['device']['kind']}, power limit {pl}; peak "
        f"{result['device']['memory_peak_bytes']} B; reference "
        f"{notes['reference_s']:.2f} s")
    log("set-up marks (s since start): " + ", ".join(
        f"{k} {v:.3f}" for k, v in notes["marks"].items()))
    log(f"losses program {notes['program']['losses']} reference "
        f"{notes['reference']['losses']}")
    for name, r in result["check"].items():
        log(f"check {name}: {r['value']:.6g} (limit {r['limit']:.6g})")
    print(json.dumps(result), flush=True)
    return 0
