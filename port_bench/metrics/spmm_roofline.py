"""Kernels: the least time the traced epochs' sparse applies need (from
the operators' shapes, ``cost.apply_bound_s``) over the device time of
the kernels of the ``spmm`` families of ``kernels/`` in the trace.

The time side counts only the kernels those families name.  It leaves
out the ``fill`` launches that zero K2's accumulated outputs before an
apply (the trace cannot tell them from the step's other fills), so it
reads the kernels a little faster than the applies are: a later change
that folds the zeroing into K2 moves that time into the count and can
lower this metric while the epoch gets faster.  ``mfu`` bounds such a
change."""
from port_bench import cost


def read(run):
    if run.trace is None or not run.applies_per_epoch:
        return None
    spent = run.trace.family_seconds(spmm=True)
    if spent <= 0:
        return None
    need = run.traced_epochs * sum(cost.apply_bound_s(a)
                                   for a in run.applies_per_epoch)
    return 100.0 * need / spent
