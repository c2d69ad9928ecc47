"""The operations the window's NLL evaluations need (counted by the program's spans lbfgs.value and lbfgs.gradient, at the cell's real N) over the window at the fp32 peak."""

from gpbench import readers
from portfoliooptgp_tpu_torch.utils import profiling


def read(run):
    return readers.span_mfu_pct(run, getattr(profiling, "SPANS", {}))
