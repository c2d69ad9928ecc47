"""The cluster kernel's least time (masked, per variant) over its traced time."""

from gpbench import readers


def read(run):
    return readers.roofline_pct(run)
