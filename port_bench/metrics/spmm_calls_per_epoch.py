"""Operator layer: kernel wrapper calls an epoch (``ops.cuda``'s launch
counters; a captured epoch's are counted at its capture)."""


def read(run):
    return run.calls_per_epoch
