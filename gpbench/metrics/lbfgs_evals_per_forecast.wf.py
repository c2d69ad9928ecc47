"""Fused NLL evaluations (cluster-kernel launches, value-only and with W alike) per forecast."""

from gpbench import readers


def read(run):
    return readers.per(run, "cluster_launches", "forecasts")
