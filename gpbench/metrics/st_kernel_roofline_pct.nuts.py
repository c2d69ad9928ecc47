"""The cluster kernel's least time (unmasked, with W) over its traced time."""

from gpbench import readers


def read(run):
    return readers.roofline_pct(run)
