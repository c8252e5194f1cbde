"""The 95th percentile of the window's epoch times, each the interval
between the CUDA events recorded before and after it on the stream."""
import statistics


def read(run):
    if len(run.epoch_s) < 2:
        return None
    return 1e3 * statistics.quantiles(run.epoch_s, n=100)[94]
