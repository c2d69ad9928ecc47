"""Day-ahead forecasts (f_mean, f_var) that whole walk-forward calls of the window returned, per second of the whole window."""

from gpbench import readers


def read(run):
    return readers.rate(run, "forecasts")
