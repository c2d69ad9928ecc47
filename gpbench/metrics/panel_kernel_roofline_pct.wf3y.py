"""The panel kernel's least time (`costs.panel_bound_ms` of each panel height at the cell's batch) over its traced time."""

from gpbench import readers


def read(run):
    return readers.panel_roofline_pct(run)
