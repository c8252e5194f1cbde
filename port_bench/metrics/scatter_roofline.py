"""Kernels: the least time the traced epochs' segment sums need (from
their shapes, ``cost_scatter.scatter_bound_s``) over the device time of
the kernels that ``kernels/scatter_sum.json`` names in the trace.

The time side counts only those kernels: the combine of a cut row's
pieces (``kernels/cut_row_combine.json``, shared with K1/K2's duals) is
left out, so the metric reads the segment sums a little faster than
they are where rows are cut."""
from port_bench import cost_scatter
from port_bench.trace import family_of

FAMILY = "scatter_sum"


def read(run):
    if run.trace is None or not run.applies_per_epoch or not all(
            isinstance(a, cost_scatter.Scatter)
            for a in run.applies_per_epoch):
        return None
    spent = 0.0
    for name, s, e in run.trace.ops:
        fam = family_of(name, run.trace.families)
        if fam is not None and fam["file"] == FAMILY:
            spent += (e - s) / 1e6
    if spent <= 0:
        return None
    need = run.traced_epochs * sum(cost_scatter.scatter_bound_s(a)
                                   for a in run.applies_per_epoch)
    return 100.0 * need / spent
