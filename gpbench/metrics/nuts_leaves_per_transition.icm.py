"""Leaves per lockstep transition: cluster-kernel launches (one ICM value and gradient a leaf) per transition."""

from gpbench import readers


def read(run):
    return readers.per(run, "cluster_launches", "steps")
