"""Seconds from the start of the process to the start of the window:
imports, the card's context, loading (or building) the kernels, the
cell's inputs and its warm-up."""


def read(run):
    return run.setup_s
