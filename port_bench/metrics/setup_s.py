"""Seconds from the process's start to the window's: imports, the built
kernels, the inputs from the seed, the port's preparation, the model,
the first epochs, the capture and the warm-up."""


def read(run):
    return run.setup_s
