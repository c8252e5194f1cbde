"""The graph's input edges times the epochs completed in the window, over
the window's seconds (first dispatch to the synchronize after the last)."""


def read(run):
    return run.edges * run.window_epochs / run.window_s \
        if run.window_s > 0 else None
