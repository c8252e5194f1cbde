"""Instrumentation: the port's spans and its call counters.

The bottom layer of the port: every layer above it (the kernels' wrappers,
the operators, the models, the losses, the trainer) marks its work here,
and this module imports only the standard library and torch.

**Spans.**  The port marks its layers with spans named ``pgsd.<name>``:
``spmm.apply`` (every kernel-tier apply, ``ops/spmm.py``),
``kernel.<wrapper>`` (each launch of a CUDA kernel wrapper, at its launch
counter), ``nn.<layer>`` (the models' layers), ``loss.<name>``,
``prep.layout`` (``ops/layout.build_layout``), ``prep.spectral_features``
and ``prep.motifs`` (the signed models' inputs) and
``train.optimizer_build`` (``train.optim.adam``'s factory).  Spans are
off by default: ``span`` then returns one shared object that does
nothing.  ``set_tracing(True)`` (or the block of ``train.trace``) turns
them on; each span then opens a ``torch.profiler.record_function`` named
by ``label(name, attrs)``, so a profile shows it around the device work it
launched, and keeps ``SpanRecord(name, attrs, t0, t1, thread)`` on the
``time.perf_counter_ns`` clock in memory until ``drain`` hands the
records out.

A layer span (``layer_span`` / ``@layer``) reaches into the backward:
its inputs and outputs that need a gradient pass through identity
autograd Functions (views, no device work), the output's backward opens
``<name>.backward`` and the input's closes it.  Where no input of a span
needs a gradient, its backward closes at the next marker on its thread
that is not inside it, or when the backward pass ends.

In a CUDA graph capture, ``capture_table`` tables each span against the
capture's kernel, memset and memcpy nodes (read from the CUDA driver):
a replay runs those nodes in capture order on one stream, so
``train.profiling.attribute`` maps a replay's device operations onto the
spans by position.

**Counters.**  A module declares its call counters once, in a named
group: ``LAUNCHES = counter("kernels", ("bsr_spmm",))`` returns the dict
it increments.  ``counts(group)`` reads a group's counters merged, and
``reset_counts()`` zeroes every group.  The groups: ``"kernels"`` (the
launches of the sparse kernel wrappers and of the attention's edge
kernel, ``ops.cuda.launch_counts()``), ``"complex_epilogue"`` (MagNetConv's
epilogue kernel), ``"magnet_fused"`` (MagNetConv's fused path) and
``"attends"`` (the attention aggregates by aggregate).
"""
import contextlib
import ctypes
import functools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch


PREFIX = "pgsd."
_ON = False
_RECORDS: List["SpanRecord"] = []


class SpanRecord(NamedTuple):
    """One closed span: ``t0`` and ``t1`` in ``time.perf_counter_ns``
    nanoseconds, ``thread`` the ``threading.get_ident`` that closed it."""

    name: str
    attrs: Dict[str, object]
    t0: int
    t1: int
    thread: int


def set_tracing(on: bool) -> None:
    """Turn the port's spans on or off (process-wide)."""
    global _ON
    _ON = bool(on)


def tracing() -> bool:
    return _ON


def drain() -> List[SpanRecord]:
    """The records of the spans closed since the last drain, in closing
    order; the list is emptied."""
    out = _RECORDS[:]
    del _RECORDS[:len(out)]
    return out


def label(name: str, attrs: Dict[str, object]) -> str:
    """The profiler name of a span: ``pgsd.<name>`` and its attributes,
    ``pgsd.spmm.apply(layout=split,rows=8,...)``."""
    if not attrs:
        return PREFIX + name
    return PREFIX + name + "(" + ",".join(
        f"{k}={v}" for k, v in attrs.items()) + ")"


def parse_label(text: str) -> Optional[Tuple[str, Dict[str, object]]]:
    """``(name, attrs)`` of a profiler name made by ``label`` (integer
    attributes as ints), or None for another name."""
    if not text.startswith(PREFIX):
        return None
    body = text[len(PREFIX):]
    if not body.endswith(")") or "(" not in body:
        return body, {}
    name, _, args = body[:-1].partition("(")
    attrs = {}
    for item in args.split(","):
        k, _, v = item.partition("=")
        attrs[k] = int(v) if v.lstrip("-").isdigit() else v
    return name, attrs


# ---------------------------------------------------------------------------
# Spans


NO_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "attrs", "_rf", "_row", "_t0")

    def __init__(self, name: str, attrs: Dict[str, object]):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self._rf = torch.profiler.record_function(label(self.name,
                                                        self.attrs))
        self._rf.__enter__()
        self._row = _table_open(self.name, self.attrs)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _RECORDS.append(SpanRecord(self.name, self.attrs, self._t0, t1,
                                   threading.get_ident()))
        _table_close(self._row)
        self._rf.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A context manager marking ``pgsd.<name>`` with ``attrs``; with the
    spans off, one shared object that does nothing."""
    if not _ON:
        return NO_SPAN
    return _Span(name, attrs)


# ---------------------------------------------------------------------------
# Layer spans: markers that carry a span into the backward


class _Layer:
    """One call of a layer span: its name, attributes and the layer span
    it was called inside (on the forward thread)."""

    __slots__ = ("name", "attrs", "parent", "open")

    def __init__(self, name: str, attrs: Dict[str, object],
                 parent: Optional["_Layer"]):
        self.name, self.attrs, self.parent = name, attrs, parent
        self.open = None

    def inside(self, other: "_Layer") -> bool:
        s = self
        while s is not None:
            if s is other:
                return True
            s = s.parent
        return False


_local = threading.local()
_BACKWARD: Dict[int, List[_Layer]] = {}   # open backward spans by thread
_pass_pending = False                     # a backward pass will close them


def _forward_stack() -> List[_Layer]:
    st = getattr(_local, "layers", None)
    if st is None:
        st = _local.layers = []
    return st


def _backward_stack() -> List[_Layer]:
    return _BACKWARD.setdefault(threading.get_ident(), [])


def _end(layer: _Layer) -> None:
    layer.open.__exit__(None, None, None)
    layer.open = None


def _finish_pass() -> None:
    """End of a backward pass: close every backward span still open."""
    global _pass_pending
    _pass_pending = False
    for stack in list(_BACKWARD.values()):
        while stack:
            _end(stack.pop())


def _open_backward(layer: _Layer) -> None:
    global _pass_pending
    stack = _backward_stack()
    while stack and not layer.inside(stack[-1]):
        _end(stack.pop())
    if not _pass_pending:
        _pass_pending = True
        torch.autograd.Variable._execution_engine.queue_callback(_finish_pass)
    layer.open = _Span(layer.name + ".backward", layer.attrs).__enter__()
    stack.append(layer)


def _close_backward(layer: _Layer) -> None:
    stack = _backward_stack()
    while layer.open is not None and stack:
        _end(stack.pop())


class _Marker(torch.autograd.Function):
    """Identity (views) on a layer's tensors."""

    @staticmethod
    def forward(ctx, layer, *xs):
        ctx.layer = layer
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)


class _MarkIn(_Marker):
    """On a layer's inputs: the backward closes its backward span."""

    @staticmethod
    def backward(ctx, *grads):
        _close_backward(ctx.layer)
        return (None, *grads)


class _MarkOut(_Marker):
    """On a layer's outputs: the backward opens its backward span."""

    @staticmethod
    def backward(ctx, *grads):
        _open_backward(ctx.layer)
        return (None, *grads)


def _mark(fn, layer: _Layer, values):
    """``values`` (a sequence) with each tensor that needs a gradient
    passed through the marker ``fn``; the others as they are."""
    at = [i for i, v in enumerate(values)
          if isinstance(v, torch.Tensor) and v.requires_grad]
    if not at:
        return values
    out = list(values)
    for i, v in zip(at, fn.apply(layer, *(values[i] for i in at))):
        out[i] = v
    return out


def layer_span(name: str, fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` inside the span ``name``, carried into the
    backward by markers on the tensor arguments and the tensor outputs (a
    tensor or a tuple) that need a gradient; with the spans off, just the
    call."""
    if not _ON:
        return fn(*args, **kwargs)
    return _layer_call(name, {}, True, fn, args, kwargs)


def _layer_call(name: str, attrs: Dict[str, object], mark_inputs: bool,
                fn: Callable, args, kwargs):
    stack = _forward_stack()
    layer = _Layer(name, attrs, stack[-1] if stack else None)
    grad = torch.is_grad_enabled()
    with _Span(name, attrs):
        stack.append(layer)
        try:
            if grad and mark_inputs:
                args = _mark(_MarkIn, layer, args)
            out = fn(*args, **kwargs)
        finally:
            stack.pop()
        if grad:
            if isinstance(out, torch.Tensor):
                out = _mark(_MarkOut, layer, (out,))[0]
            elif isinstance(out, tuple):
                out = tuple(_mark(_MarkOut, layer, out))
    return out


def layer(name: str, attrs: Optional[Callable[..., Dict[str, object]]]
          = None, mark_inputs: bool = True):
    """Decorator form of ``layer_span``: the function (or method) runs as
    the layer span ``name``.  ``attrs``, given the call's arguments,
    returns the span's attributes (its backward's too); it is called only
    with the spans on.  ``mark_inputs=False`` puts no marker on the
    inputs, so the backward span closes at the next marker outside it or
    when the pass ends: for a layer that reads an input shared with other
    layers more than once (a loss gathering the embedding at both ends of
    every edge), whose input marker would sum those reads' gradients
    apart from the other layers' before adding them in, a regrouping that
    changes the gradient's rounding."""

    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _ON:
                return fn(*args, **kwargs)
            return _layer_call(name, attrs(*args, **kwargs) if attrs
                               else {}, mark_inputs, fn, args, kwargs)

        return traced

    return wrap


# ---------------------------------------------------------------------------
# Spans in a CUDA graph capture


class SpanRow(NamedTuple):
    """A span of a capture: its device nodes are ``[start, stop)`` in
    capture order (kernel, memset and memcpy nodes only)."""

    name: str
    attrs: Dict[str, object]
    start: int
    stop: int


@dataclass
class SpanTable:
    """The spans of one CUDA graph capture, in the order they opened, and
    ``nodes``, the capture's kernel, memset and memcpy nodes."""

    rows: List[SpanRow] = field(default_factory=list)
    nodes: int = 0


class _NodeCounter:
    """Kernel, memset and memcpy nodes so far in the graph that a stream
    is capturing into, through the CUDA driver torch has loaded (ctypes);
    each node's type is read once."""

    KINDS = (0, 1, 2)            # CU_GRAPH_NODE_TYPE_KERNEL, MEMCPY, MEMSET

    def __init__(self):
        lib = ctypes.CDLL("libcuda.so.1")
        p = ctypes.c_void_p
        for name, extra in (("cuStreamGetCaptureInfo_v3", 3),
                            ("cuStreamGetCaptureInfo_v2", 2)):
            if hasattr(lib, name):
                self._info, self._extra = getattr(lib, name), extra
                break
        else:
            raise RuntimeError("the CUDA driver has no "
                               "cuStreamGetCaptureInfo_v2 or _v3")
        self._info.argtypes = [p] * (4 + self._extra)
        self._info.restype = ctypes.c_int
        self._nodes = lib.cuGraphGetNodes
        self._nodes.argtypes = [p, p, p]
        self._nodes.restype = ctypes.c_int
        self._type = lib.cuGraphNodeGetType
        self._type.argtypes = [p, p]
        self._type.restype = ctypes.c_int
        self._types: Dict[int, int] = {}

    def __call__(self, stream: int) -> int:
        status, graph = ctypes.c_int(0), ctypes.c_void_p()
        _check(self._info(stream, ctypes.byref(status), None,
                          ctypes.byref(graph), *([None] * self._extra)),
               "cuStreamGetCaptureInfo")
        if status.value != 1 or not graph.value:  # ..._STATUS_ACTIVE
            raise RuntimeError("the stream is not capturing")
        n = ctypes.c_size_t(0)
        _check(self._nodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
        if not n.value:
            return 0
        nodes = (ctypes.c_void_p * n.value)()
        _check(self._nodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
        count, kind = 0, ctypes.c_int()
        for node in nodes[:n.value]:
            t = self._types.get(node)
            if t is None:
                _check(self._type(node, ctypes.byref(kind)),
                       "cuGraphNodeGetType")
                t = self._types[node] = kind.value
            count += t in self.KINDS
        return count


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


_TABLE: Optional[SpanTable] = None
_counter: Optional[Callable[[int], int]] = None


def _count(stream: int) -> int:
    global _counter
    if _counter is None:
        _counter = _NodeCounter()
    return _counter(stream)


def _capture_stream() -> Optional[int]:
    """The current CUDA stream where it is capturing, else None."""
    if not torch.cuda.is_current_stream_capturing():
        return None
    return torch.cuda.current_stream().cuda_stream


def _table_open(name: str, attrs):
    if _TABLE is None:
        return None
    stream = _capture_stream()
    if stream is None:
        return None
    row = [name, attrs, _count(stream), None, stream]
    _TABLE.rows.append(row)
    return row


def _table_close(row) -> None:
    if row is not None:
        row[3] = _count(row[4])


@contextlib.contextmanager
def capture_table():
    """Enter inside ``torch.cuda.graph(...)``: with the spans on, yields
    the ``SpanTable`` of the spans opened in the block while their stream
    captures (complete when the block ends); with them off, None."""
    global _TABLE
    if not _ON:
        yield None
        return
    table, prev = SpanTable(), _TABLE
    _TABLE = table
    try:
        yield table
        table.nodes = _count(_capture_stream())
    finally:
        _TABLE = prev
        rows, table.rows = table.rows, []
        for name, attrs, start, stop, _ in rows:
            table.rows.append(SpanRow(name, attrs, start,
                                      start if stop is None else stop))




# ---------------------------------------------------------------------------
# Counters

_GROUPS: Dict[str, List[Dict[str, int]]] = {}


def counter(group: str, keys: Iterable[str]) -> Dict[str, int]:
    """A dict of counters, each of ``keys`` at 0, declared in ``group``:
    its module increments the dict's entries."""
    counts_ = dict.fromkeys(keys, 0)
    _GROUPS.setdefault(group, []).append(counts_)
    return counts_


def counts(group: str) -> Dict[str, int]:
    """The counters of ``group`` by name, in a new dict."""
    out: Dict[str, int] = {}
    for counts_ in _GROUPS.get(group, ()):
        out.update(counts_)
    return out


def reset_counts() -> None:
    """Zero every counter of every group."""
    for group in _GROUPS.values():
        for counts_ in group:
            for k in counts_:
                counts_[k] = 0
