"""The operations the window's NLL evaluations need over the window at the fp32 peak."""

from gpbench import readers


def read(run):
    return readers.step_mfu_pct(run)
