"""The optimizer's own host milliseconds an iteration: self time of the program's span lbfgs.iteration (its evaluations and host syncs left out) ÷ its count."""

from portfoliooptgp_tpu_torch.utils import profiling


def read(run):
    it = getattr(profiling, "SPANS", {}).get("lbfgs.iteration")
    return it[2] * 1e-6 / it[0] if it else None
