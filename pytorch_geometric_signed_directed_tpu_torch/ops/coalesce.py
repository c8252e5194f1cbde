"""Shared host-side edge coalescing (numpy).

Counterpart of ``pytorch_geometric_signed_directed_tpu/ops/coalesce.py``,
numpy branch only: the same arrays for the same input.
"""
from typing import Tuple

import numpy as np


def coalesce_edges(row, col, *values, num_cols: int,
                   ) -> Tuple[np.ndarray, ...]:
    """Sort edges by (row, col) and sum duplicate entries of each value
    array.  Returns (row, col, *summed_values).

    One stable argsort of int64 linear keys + add.reduceat over contiguous
    duplicate runs.  Integer value arrays are summed in float64."""
    row = np.asarray(row, np.int64).ravel()
    col = np.asarray(col, np.int64).ravel()
    key = row * np.int64(num_cols) + col
    order = np.argsort(key, kind="stable")
    ks = key[order]
    starts = np.concatenate(
        [[0], np.flatnonzero(np.diff(ks)) + 1]) if len(ks) else np.zeros(
            0, np.int64)
    uniq = ks[starts] if len(ks) else ks
    out_vals = []
    for v in values:
        v = np.asarray(v)
        dt = v.dtype if np.issubdtype(v.dtype, np.floating) else np.float64
        s = (np.add.reduceat(v[order].astype(dt), starts)
             if len(ks) else np.zeros(0, dt))
        out_vals.append(s)
    return (uniq // num_cols, uniq % num_cols, *out_vals)
