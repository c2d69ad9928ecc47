"""The cluster kernel's least time (unmasked, with W, at the cell's C·P shifted systems) over its traced time."""

from gpbench import readers


def read(run):
    return readers.roofline_pct(run)
