"""NLL evaluations per forecast: count(lbfgs.value) + count(lbfgs.gradient) of the program's spans ÷ forecasts."""

from gpbench import readers
from portfoliooptgp_tpu_torch.utils import profiling


def read(run):
    return readers.evals_per(run, getattr(profiling, "SPANS", {}), "forecasts")
