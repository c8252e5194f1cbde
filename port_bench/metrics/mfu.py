"""Model step: the operations an epoch requires (counted from the
configuration's shapes: dense transforms and 2 nnz W a sparse apply,
forward, backward and evaluation, nothing recomputed) over the mean
epoch time of the traced window times the card's float32 peak."""
import statistics

from port_bench import cost


def read(run):
    if run.trace is None or not run.traced_epoch_s or not run.flops_per_epoch:
        return None
    return 100.0 * run.flops_per_epoch / (
        statistics.fmean(run.traced_epoch_s) * cost.F32_FLOPS_PER_S)
