"""Profiling / timing harness.

Counterpart of ``pytorch_geometric_signed_directed_tpu/train/
profiling.py``: a ``torch.profiler`` trace, and a step timer that
synchronizes the card before and after (as ``block_until_ready`` does).
"""
import contextlib
import time
from typing import Callable

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the block into ``logdir``
    (TensorBoard's trace format); yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                logdir)) as prof:
        yield prof


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
