"""Profiling: a ``torch.profiler`` trace, a timer, and the reading of a
profile by the port's spans.

Counterpart of ``pytorch_geometric_signed_directed_tpu/train/
profiling.py``: a ``torch.profiler`` trace, and a step timer that
synchronizes the card before and after (as ``block_until_ready`` does).

The spans themselves, and the capture table of a CUDA graph, are the
port's bottom layer (``instrument``).  ``attribute`` maps a profile's
device operations to the innermost span around their launch through the
profiler's correlation ids, and a replay's operations onto its capture
table by position (``map_replay``).
"""
import contextlib
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .. import instrument
from ..instrument import PREFIX, SpanTable, parse_label, set_tracing, tracing


# ---------------------------------------------------------------------------
# Reading a profile: each device operation and the spans around it


@dataclass(frozen=True)
class Span:
    """One occurrence of a span in a profile: ``name`` without the
    prefix, and ``attrs``."""

    name: str
    attrs: Tuple[Tuple[str, object], ...]

    def attr(self, k: str, default=None):
        return dict(self.attrs).get(k, default)


@dataclass(frozen=True)
class DeviceOp:
    """A device operation (microseconds on the profiler's clock) and the
    port spans around its launch, outermost first."""

    name: str
    start: float
    end: float
    spans: Tuple[Span, ...]

    @property
    def innermost(self) -> Optional[Span]:
        return self.spans[-1] if self.spans else None


@dataclass
class Attribution:
    """Every device operation of a profile with its spans, every span
    occurrence (eager ones, and each row of each replay), and the count
    of graph replays mapped."""

    ops: List[DeviceOp]
    spans: List[Span]
    replays: int = 0

    def by_span(self, epochs: int) -> Dict[str, Tuple[float, float]]:
        """For each span name: (occurrences an epoch, device ms an epoch of
        the operations whose innermost span it is)."""
        out = {}
        for s in self.spans:
            n, ms = out.get(s.name, (0, 0.0))
            out[s.name] = (n + 1, ms)
        for op in self.ops:
            s = op.innermost
            if s is not None:
                n, ms = out.get(s.name, (0, 0.0))
                out[s.name] = (n, ms + (op.end - op.start) / 1e3)
        return {k: (n / epochs, ms / epochs) for k, (n, ms) in out.items()}


def map_replay(n_ops: int, table: SpanTable
               ) -> Optional[List[Tuple[int, ...]]]:
    """For each of a replay's ``n_ops`` device operations, in start order,
    the indices of the table's rows around its node, outermost first; None
    where the count differs from the table's nodes."""
    if n_ops != table.nodes:
        return None
    out = [[] for _ in range(n_ops)]
    for r, row in enumerate(table.rows):
        for i in range(row.start, min(row.stop, n_ops)):
            out[i].append(r)
    return [tuple(x) for x in out]


def _is_device(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(PREFIX))


def _frozen(attrs: Dict[str, object]) -> Tuple[Tuple[str, object], ...]:
    return tuple(attrs.items())


def attribute(events, table: Optional[SpanTable] = None
              ) -> Optional[Attribution]:
    """Each device operation of a ``torch.profiler`` profile (``events``:
    the profiler, or its ``events()``) with the port spans around it.

    An eager operation is matched by its correlation id to its launch
    call (a CPU event named ``cu...``), and takes the ``pgsd.`` spans on
    the launching thread whose time holds the launch.  The operations of
    one graph launch are taken in start order and mapped by position onto
    ``table`` (``SplitRun.span_table``).  Returns None, and says why in one
    line on stderr, where a replay's operations do not match the table's
    node count, or a replay has no table."""
    events = list(events.events() if hasattr(events, "events") else events)
    launches, spans_by_thread, device = {}, {}, []
    spans: List[Span] = []
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU:
            parsed = parse_label(e.name)
            if parsed is not None:
                tr = e.time_range
                s = Span(parsed[0], _frozen(parsed[1]))
                spans_by_thread.setdefault(e.thread, []).append(
                    (tr.start, tr.end, s))
                spans.append(s)
            elif e.name.startswith("cu"):
                launches[e.id] = e
        elif _is_device(e):
            device.append(e)

    ops: List[DeviceOp] = []
    graphs: Dict[int, list] = {}
    queries: Dict[int, list] = {}
    for e in device:
        launch = launches.get(e.id)
        if launch is not None and "GraphLaunch" in launch.name:
            graphs.setdefault(e.id, []).append(e)
        elif launch is not None:
            queries.setdefault(launch.thread, []).append(
                (launch.time_range.start, e))
        else:
            ops.append(DeviceOp(e.name, e.time_range.start,
                                e.time_range.end, ()))
    for thread, qs in queries.items():
        for e, around in _around(spans_by_thread.get(thread, []), qs):
            ops.append(DeviceOp(e.name, e.time_range.start, e.time_range.end,
                                around))

    replays = 0
    for group in graphs.values():
        if table is None:
            _say(f"{len(group)} replayed device operations and no span "
                 f"table")
            return None
        group.sort(key=lambda e: e.time_range.start)
        rows = map_replay(len(group), table)
        if rows is None:
            _say(f"a replay ran {len(group)} device operations, its capture "
                 f"table holds {table.nodes} nodes")
            return None
        mine = [Span(r.name, _frozen(r.attrs)) for r in table.rows]
        spans += mine
        for e, at in zip(group, rows):
            ops.append(DeviceOp(e.name, e.time_range.start, e.time_range.end,
                                tuple(mine[i] for i in at)))
        replays += 1
    ops.sort(key=lambda op: op.start)
    return Attribution(ops, spans, replays)


def _around(intervals, queries):
    """For each (time, item) of ``queries``: the item and the spans of
    ``intervals`` ((start, end, span)) that hold the time, outermost
    first."""
    edges = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    open_, j = [], 0
    for t, item in sorted(queries, key=lambda q: q[0]):
        while j < len(edges) and edges[j][0] <= t:
            open_.append(edges[j])
            j += 1
        open_ = [iv for iv in open_ if iv[1] >= t]
        yield item, tuple(iv[2] for iv in open_)


def _say(why: str) -> None:
    print(f"pgsd spans: no attribution: {why}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# A trace and a timer


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the block into ``logdir``
    (TensorBoard's trace format), with the port's ``pgsd.`` spans on for
    the block (their previous state is restored after it, and their
    records dropped if they were off); yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    was = tracing()
    kept = len(instrument._RECORDS)
    set_tracing(True)
    try:
        with torch.profiler.profile(
                activities=acts,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    logdir)) as prof:
            yield prof
    finally:
        set_tracing(was)
        if not was:
            del instrument._RECORDS[kept:]


def time_fn(fn: Callable, *args, iters: int = 50, warmup: int = 2,
            **kwargs) -> float:
    """Seconds per call by the host clock, the card synchronized before
    and after the timed calls."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    _sync()
    return (time.perf_counter() - t0) / iters


def edges_per_second(fn: Callable, num_edges: int, *args, iters: int = 50,
                     **kwargs) -> float:
    """Throughput of a graph op / train step in edges per second."""
    return num_edges / time_fn(fn, *args, iters=iters, **kwargs)
