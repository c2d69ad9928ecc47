"""Draws (chains x transitions completed) per second of the whole window."""

from gpbench import readers


def read(run):
    return readers.rate(run, "draws")
