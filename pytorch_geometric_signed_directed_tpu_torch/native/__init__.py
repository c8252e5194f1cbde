"""The native host tier: ``csrc/pgsd_native.cpp`` bound with ctypes.

Counterpart of ``pytorch_geometric_signed_directed_tpu/native/__init__.py``.
``csrc/pgsd_native.cpp`` is this package's own copy of the JAX package's
source (byte for byte), compiled at first use with ``g++ -O3 -std=c++17
-shared -fPIC`` (the JAX package's flags) into
``build/native/libpgsd_native_<hash>.so`` at the root of the checkout,
keyed by the source's hash.  Nothing falls back: where the tier is used
and the build fails, the call raises with g++'s output, and every entry
returns its arrays (the JAX binding returns None without a toolchain).

The host code calls it at the JAX package's thresholds, above which both
packages give the same arrays bit for bit: ``ops/coalesce.py``
(``coalesce_multi`` from 2^21 entries, ``stable_argsort`` for keys wider
than 32 bits from 2^20), ``spectral/magnetic.py`` (``symmetrize`` and
``magnetic_sym_lap`` from 2^20 edges) and ``data/load_real.py``
(``parse_signed_csv`` for the signed CSV files).  ``plan_layout``,
``window_hist`` and ``permute_gather`` serve the TPU's window layout,
which the port replaced with CSR (``ops/layout.py``): they are bound and
tested, and nothing calls them.
"""
import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "pgsd_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "native")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
# keys below this many entries sort faster in numpy than by the radix sort
ARGSORT_MIN = 1 << 20

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libpgsd_native_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the source unless its library exists; returns the library's
    path.  A failed compile raises with g++'s output."""
    target = library_path()
    if os.path.isfile(target):
        return target
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, SOURCE, "-o", tmp],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"the native tier needs g++: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, target)  # atomic: concurrent builders never see half a file
    return target


def _pointer(dtype):
    return np.ctypeslib.ndpointer(dtype, flags="C_CONTIGUOUS")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, f32, f64 = _pointer(np.int64), _pointer(np.float32), \
        _pointer(np.float64)
    p, n = ctypes.c_void_p, ctypes.c_int64
    sigs = {
        "pgsd_parse_csv": (p, [ctypes.c_char_p]),
        "pgsd_num_edges": (n, [p]),
        "pgsd_num_nodes": (n, [p]),
        "pgsd_fill": (None, [p, i64, i64, f32]),
        "pgsd_free": (None, [p]),
        "pgsd_coalesce": (n, [i64, i64, f32, n, n]),
        "pgsd_argsort_u64": (None, [_pointer(np.uint64), n, i64]),
        "pgsd_coalesce_fused": (n, [_pointer(np.uint64), f64, n, n]),
        "pgsd_magnetic_sym_lap": (n, [i64, i64, f64, n, n, ctypes.c_double,
                                      n, i64, i64, f64, f64]),
        # the group pointer is int8* or None
        "pgsd_plan_build": (p, [i64, p, n, n, n, n, n]),
        "pgsd_plan_total": (n, [p]),
        "pgsd_plan_chunks": (n, [p]),
        "pgsd_plan_hot_chunks": (n, [p]),
        "pgsd_plan_fill": (None, [p, i64, _pointer(np.int32),
                                  _pointer(np.int32), _pointer(np.int32),
                                  _pointer(np.uint8)]),
        "pgsd_plan_free": (None, [p]),
        "pgsd_window_hist": (None, [i64, p, n, n, n, i64]),
        "pgsd_permute_gather": (None, [i64, n, ctypes.c_char_p,
                                       ctypes.c_char_p, n]),
        "pgsd_symmetrize": (n, [i64, i64, f64, n, n, i64, i64, f64, f64,
                                f64]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(build()))
        return _lib


def available() -> bool:
    """True when the library builds (or is built) and loads: the JAX
    binding's ``available``.  The entry points still raise where it is
    False, with g++'s output."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def parse_signed_csv(path: str) -> Tuple[np.ndarray, np.ndarray,
                                         np.ndarray, int]:
    """``(rows, cols, weights, num_nodes)`` of an ``a,b,w`` CSV edge list:
    int64 node ids in first-seen order (the reference's Python dict loop)
    and float32 weights."""
    lib = _load()
    h = lib.pgsd_parse_csv(os.fsencode(path))
    if not h:
        raise FileNotFoundError(path)
    try:
        e = lib.pgsd_num_edges(h)
        n = lib.pgsd_num_nodes(h)
        rows = np.empty(e, np.int64)
        cols = np.empty(e, np.int64)
        w = np.empty(e, np.float32)
        lib.pgsd_fill(h, rows, cols, w)
    finally:
        lib.pgsd_free(h)
    return rows, cols, w, int(n)


def stable_argsort(keys: np.ndarray) -> np.ndarray:
    """Stable argsort of non-negative int keys: the native LSD radix sort
    for ``ARGSORT_MIN`` keys or more when one is wider than 32 bits (the
    composite row * num_cols + col keys of a large graph), numpy's
    otherwise.  A stable sort has one answer, so both give the same
    permutation."""
    keys = np.asarray(keys)
    if keys.size < ARGSORT_MIN or int(keys.max(initial=0)) < (1 << 32):
        return np.argsort(keys, kind="stable")
    perm = np.empty(len(keys), np.int64)
    _load().pgsd_argsort_u64(np.ascontiguousarray(keys, np.uint64),
                             len(keys), perm)
    return perm


def coalesce_multi(keys: np.ndarray, *values) -> tuple:
    """Sorted unique keys and the sum of each value array over each run of
    equal keys, in one pass (threaded radix argsort, then one accumulate).
    Sums are taken in float64.  Returns ``(unique_keys int64, *sums
    float64)``."""
    src = np.asarray(keys)
    if len(src) == 0:
        return (np.zeros(0, np.int64),
                *(np.zeros(0, np.float64) for _ in values))
    lib = _load()
    # the call sorts keys in place: copy unless the conversion already did
    keys = np.ascontiguousarray(src, np.uint64)
    if keys is src or keys.base is src:
        keys = keys.copy()
    n = len(keys)
    vals = np.ascontiguousarray(
        np.stack([np.asarray(v, np.float64) for v in values])
        if values else np.zeros((0, n)))
    m = lib.pgsd_coalesce_fused(keys, vals, n, len(values))
    return (keys[:m].astype(np.int64),
            *(vals[v, :m] for v in range(len(values))))


def coalesce(rows: np.ndarray, cols: np.ndarray, weights: np.ndarray,
             num_cols: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort by (row, col) and sum duplicates (float32 weights); returns
    trimmed copies."""
    lib = _load()
    rows = np.ascontiguousarray(rows, np.int64).copy()
    cols = np.ascontiguousarray(cols, np.int64).copy()
    weights = np.ascontiguousarray(weights, np.float32).copy()
    out = lib.pgsd_coalesce(rows, cols, weights, len(rows), num_cols)
    return rows[:out], cols[:out], weights[:out]


def _group_pointer(group: Optional[np.ndarray]):
    """``(int8 array or None, its pointer or None, groups)``; the caller
    keeps the array alive for the call."""
    if group is None:
        return None, None, 1
    garr = np.ascontiguousarray(group, np.int8)
    return garr, garr.ctypes.data_as(ctypes.c_void_p), 2


def plan_layout(row: np.ndarray, num_rows: int, window: int, chunk: int,
                group: Optional[np.ndarray] = None) -> dict:
    """The TPU scatter plan's host layout (the JAX package's
    ``ops/pallas/scatter_mxu._build_plan_host`` after its geometry): one
    stable radix argsort by (group, window, local row), then one threaded
    pass that lays out the chunks.  Returns the plan's fields (perm, lr,
    gr, win, visited, hot_chunks, ...)."""
    lib = _load()
    row = np.ascontiguousarray(row, np.int64)
    e = len(row)
    garr, gptr, ngrp = _group_pointer(group)
    h = lib.pgsd_plan_build(row, gptr, e, int(num_rows), int(window),
                            int(chunk), ngrp)
    try:
        total = lib.pgsd_plan_total(h)
        nchunks = lib.pgsd_plan_chunks(h)
        hot = lib.pgsd_plan_hot_chunks(h)
        perm = np.empty(total, np.int64)
        lr = np.empty(total, np.int32)
        gr = np.empty(total, np.int32)
        win = np.empty(nchunks, np.int32)
        num_windows = (max(num_rows, 1) + window - 1) // window
        visited = np.empty(num_windows, np.uint8)
        lib.pgsd_plan_fill(h, perm, lr, gr, win, visited)
    finally:
        lib.pgsd_plan_free(h)
    return dict(perm=perm, lr=lr, gr=gr, win=win,
                visited=visited.astype(bool), window=window, chunk=chunk,
                num_windows=int(num_windows), num_edges=e,
                num_rows=num_rows, hot_chunks=int(hot))


def window_hist(row: np.ndarray, group: Optional[np.ndarray],
                nbins: int) -> np.ndarray:
    """Threaded bincount of ``(row >> 7) * groups + group`` (the TPU
    geometry's finest-window degree histogram)."""
    lib = _load()
    row = np.ascontiguousarray(row, np.int64)
    garr, gptr, ngrp = _group_pointer(group)
    out = np.zeros(nbins, np.int64)
    lib.pgsd_window_hist(row, gptr, len(row), nbins, ngrp, out)
    return out


def permute_gather(perm: np.ndarray, src: np.ndarray) -> np.ndarray:
    """``out[i] = src[perm[i]]`` (0 where ``perm[i]`` is -1), threaded, for
    a 1-D ``src`` of 4- or 8-byte items."""
    src = np.ascontiguousarray(src)
    if src.ndim != 1 or src.itemsize not in (4, 8):
        raise ValueError(f"permute_gather takes 1-D 4- or 8-byte items, got "
                         f"shape {src.shape} of {src.dtype}")
    lib = _load()
    perm = np.ascontiguousarray(perm, np.int64)
    out = np.empty(len(perm), src.dtype)
    lib.pgsd_permute_gather(
        perm, len(perm), src.ctypes.data_as(ctypes.c_char_p),
        out.ctypes.data_as(ctypes.c_char_p), src.itemsize)
    return out


def symmetrize(row: np.ndarray, col: np.ndarray, w: np.ndarray,
               num_nodes: int) -> Tuple[np.ndarray, ...]:
    """The magnetic symmetrization in one pass: for each unique (i, j),
    i != j, sorted by (i, j), ``sym`` = the sum of w over both directions,
    ``theta`` = forward w less reverse w, ``abs`` = the sum of |w| over
    both directions (the caller halves sym and abs).  Self-loops are
    skipped.  Returns ``(row, col, sym, theta, abs)``, float64 sums."""
    lib = _load()
    row = np.ascontiguousarray(row, np.int64)
    col = np.ascontiguousarray(col, np.int64)
    w = np.ascontiguousarray(w, np.float64)
    e = len(row)
    outs = [np.empty(2 * e, np.int64), np.empty(2 * e, np.int64)] + [
        np.empty(2 * e, np.float64) for _ in range(3)]
    m = lib.pgsd_symmetrize(row, col, w, e, int(num_nodes), *outs)
    return tuple(o[:m] for o in outs)


def magnetic_sym_lap(row: np.ndarray, col: np.ndarray, w: np.ndarray,
                     num_nodes: int, q: float, deg_mode: int
                     ) -> Tuple[np.ndarray, ...]:
    """The sym-normalized magnetic Laplacian in one pass: symmetrize,
    weighted degree, D^-1/2 A D^-1/2 and the phase's cos and sin, laid out
    as the sorted off-diagonal entries followed by the N diagonal ones.
    ``deg_mode``: 0 unsigned, 1 signed by the absolute degree, 2 signed by
    the absolute value of the signed degree.  Returns ``(row, col, w_re,
    w_im)``."""
    lib = _load()
    row = np.ascontiguousarray(row, np.int64)
    col = np.ascontiguousarray(col, np.int64)
    w = np.ascontiguousarray(w, np.float64)
    e, n = len(row), int(num_nodes)
    cap = 2 * e + n
    outs = [np.empty(cap, np.int64), np.empty(cap, np.int64),
            np.empty(cap, np.float64), np.empty(cap, np.float64)]
    m = lib.pgsd_magnetic_sym_lap(row, col, w, e, n, float(q), int(deg_mode),
                                  *outs)
    return tuple(o[:m + n] for o in outs)
