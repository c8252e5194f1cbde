"""Device: the share of one traced window of steady epochs in which no
operation ran on the card (the union of device intervals over the
window's span, both from the same profiler trace)."""


def read(run):
    if run.trace is None or run.trace.span_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.span_s)
