"""Train loop: host milliseconds of the call that enqueues one epoch (a
graph replay, or an eager step), averaged over a stretch of steady
epochs, each dispatched once the one before has ended (so that a full
launch queue does not pace the call), without the profiler."""
import statistics


def read(run):
    return statistics.fmean(run.dispatch_ms) if run.dispatch_ms else None
