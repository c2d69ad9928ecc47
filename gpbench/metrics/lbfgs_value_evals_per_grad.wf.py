"""Value-only evaluations per gradient in the optimizer: count(lbfgs.value) ÷ count(lbfgs.gradient) of the program's spans (the line search's trials, and a fit's first value)."""

from portfoliooptgp_tpu_torch.utils import profiling


def read(run):
    spans = getattr(profiling, "SPANS", {})
    value, grad = spans.get("lbfgs.value"), spans.get("lbfgs.gradient")
    return value[0] / grad[0] if value and grad else None
