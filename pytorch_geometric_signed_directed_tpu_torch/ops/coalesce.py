"""Shared host-side edge coalescing and unique keys.

Counterpart of ``pytorch_geometric_signed_directed_tpu/ops/coalesce.py``:
the same arrays for the same input, through the native tier
(``native.coalesce_multi``) from the same size on.
"""
from typing import Tuple

import numpy as np

from .. import native

# From this many entries the native tier's fused sort-and-sum wins (below
# it, the native path's [values, n] float64 stack copy costs more).
FUSED_COALESCE_MIN = 1 << 21


def _sum_dtype(v) -> np.dtype:
    dt = np.asarray(v).dtype
    return dt if np.issubdtype(dt, np.floating) else np.dtype(np.float64)


def coalesce_edges(row, col, *values, num_cols: int,
                   ) -> Tuple[np.ndarray, ...]:
    """Sort edges by (row, col) and sum duplicate entries of each value
    array.  Returns (row, col, *summed_values).

    One stable argsort of int64 linear keys + add.reduceat over contiguous
    duplicate runs; from ``FUSED_COALESCE_MIN`` entries on, the native
    tier's one pass, which sums in float64 and rounds once.  Integer value
    arrays are summed in float64."""
    row = np.asarray(row, np.int64).ravel()
    col = np.asarray(col, np.int64).ravel()
    key = row * np.int64(num_cols) + col
    if len(key) >= FUSED_COALESCE_MIN:
        uniq, *sums = native.coalesce_multi(key, *values)
        return (uniq // num_cols, uniq % num_cols,
                *(s.astype(_sum_dtype(v), copy=False)
                  for v, s in zip(values, sums)))
    order = native.stable_argsort(key)
    ks = key[order]
    starts = np.concatenate(
        [[0], np.flatnonzero(np.diff(ks)) + 1]) if len(ks) else np.zeros(
            0, np.int64)
    uniq = ks[starts] if len(ks) else ks
    out_vals = []
    for v in values:
        v = np.asarray(v)
        dt = _sum_dtype(v)
        s = (np.add.reduceat(v[order].astype(dt), starts)
             if len(ks) else np.zeros(0, dt))
        out_vals.append(s)
    return (uniq // num_cols, uniq % num_cols, *out_vals)


def sorted_unique(keys: np.ndarray, return_inverse: bool = False):
    """``np.unique`` of 1-D keys by one sort.  numpy >= 2.3 answers a plain
    ``np.unique`` from a hash table, which at 10^7 random int64 keys takes
    several seconds a call, many times the sort.  ``return_inverse`` also
    gives each key's index into the result."""
    if not return_inverse:
        keys = np.sort(keys)
    else:
        order = np.argsort(keys, kind="stable")
        keys = keys[order]
    keep = np.ones(len(keys), bool)
    np.not_equal(keys[1:], keys[:-1], out=keep[1:])
    if not return_inverse:
        return keys[keep]
    inverse = np.empty(len(keys), np.int64)
    inverse[order] = np.cumsum(keep) - 1
    return keys[keep], inverse
