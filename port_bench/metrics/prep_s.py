"""Host preparation: seconds from the edge list in host memory to the
features and operators on the card (host clock, ending in a synchronize)."""


def read(run):
    return run.prep_s
