"""The operations the window's ICM NLL evaluations need (their cluster-kernel launches at the C·P shifted systems) over the window at the fp32 peak."""

from gpbench import readers


def read(run):
    return readers.step_mfu_pct(run)
