"""Plain references: ``reference/<model>.py`` computes what a cell's
model computes, in plain PyTorch over scipy-built operators, from the
harness's inputs alone.  Nothing here imports the port."""
