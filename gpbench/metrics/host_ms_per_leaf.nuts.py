"""Device-idle milliseconds of the traced window per leaf."""

from gpbench import readers


def read(run):
    return readers.host_ms_per(run, "cluster_launches")
